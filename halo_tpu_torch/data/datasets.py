"""Cityscapes target set with the active-mask protocol (copy of the parts
of ``halo_tpu/data/datasets.py`` the acquisition round reads).

Samples are dicts of numpy arrays and strings, channel-last. In 'active'
mode every sample carries its native-resolution label, mask and
active/selected indicators; the mask PNG and indicator are read from the
in-process cache first, then from disk.

Label maps (``label``, ``mask``, ``origin_label``, ``origin_mask``) are
uint8 here, where the JAX copy widens them to int32: the values are the
same (0-255), and a loader worker ships a sample to the main process in
~20 MB instead of ~48 MB at 1024x2048.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
from PIL import Image, ImageFile

from . import mask_cache
from .masks import load_indicator

ImageFile.LOAD_TRUNCATED_IMAGES = True

# GTAV/Cityscapes 19-class remap.
ID_TO_TRAINID_19 = {7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5, 19: 6, 20: 7,
                    21: 8, 22: 9, 23: 10, 24: 11, 25: 12, 26: 13, 27: 14,
                    28: 15, 31: 16, 32: 17, 33: 18}
# SYNTHIA 16-class remap.
ID_TO_TRAINID_16 = {7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5, 19: 6, 20: 7,
                    21: 8, 23: 9, 24: 10, 25: 11, 26: 12, 28: 13, 32: 14,
                    33: 15}


def remap_labels(label: np.ndarray, num_classes: int,
                 ignore_label: int = 255) -> np.ndarray:
    """Vectorized id->trainid remap via a 256-entry LUT."""
    table = np.full(256, ignore_label, np.uint8)
    mapping = ID_TO_TRAINID_16 if num_classes == 16 else ID_TO_TRAINID_19
    for k, v in mapping.items():
        table[k] = v
    return table[label]


class CityscapesDataSet:
    """Cityscapes target set with the active-mask protocol."""

    def __init__(self, data_root, data_list, save_dir, num_classes=19,
                 split="train", transform=None, ignore_label=255):
        self.active = split == "active"
        if split == "active":
            split = "train"
        self.split = split
        self.num_classes = num_classes
        self.data_root = data_root
        self.save_dir = save_dir
        self.transform = transform
        self.ignore_label = ignore_label

        with open(data_list) as handle:
            names = [line.strip() for line in handle if line.strip()]
        self.data_list: List[Dict] = []
        for name in names:
            stem = name.split("_leftImg8bit")[0]
            self.data_list.append({
                "img": os.path.join(
                    data_root, f"leftImg8bit/{self.split}/{name}"),
                "label": os.path.join(
                    data_root,
                    f"gtFine/{self.split}/{stem}_gtFine_labelIds.png"),
                "label_mask": os.path.join(
                    save_dir,
                    f"gtMask/{self.split}/{stem}_gtFine_labelIds.png"),
                "indicator": os.path.join(
                    save_dir, f"gtIndicator/train/{stem}_indicator.pth"),
                "name": name,
            })

    def __len__(self):
        return len(self.data_list)

    def __getitem__(self, index):
        files = self.data_list[index]
        image = Image.open(files["img"]).convert("RGB")
        label = np.asarray(Image.open(files["label"]), dtype=np.uint8)
        if self.split == "train":
            label_mask = mask_cache.get_mask(files["label_mask"])
            if label_mask is None:
                label_mask = np.asarray(Image.open(files["label_mask"]),
                                        dtype=np.uint8)
        else:
            label_mask = np.full_like(label, 255)
        origin_mask = label_mask

        active_indicator = np.zeros((1,), bool)
        active_selected = np.zeros((1,), bool)
        if self.active:
            ind = mask_cache.get_indicator(files["indicator"])
            if ind is None:
                ind = load_indicator(files["indicator"])
            active_indicator = ind["active"]
            active_selected = ind["selected"]
            if active_indicator.shape == (1,):  # first-time init
                active_indicator = np.zeros(origin_mask.shape, bool)
                active_selected = np.zeros(origin_mask.shape, bool)

        label = remap_labels(label, self.num_classes, self.ignore_label)
        origin_label = label
        h, w = label.shape

        # label + mask ride through the transforms as one 2-channel map
        pair = np.stack([label, label_mask], axis=-1)
        if self.transform is not None:
            image, pair = self.transform(image, pair)
        return {
            "img": image,
            "label": pair[..., 0],
            "mask": pair[..., 1],
            "name": files["name"],
            "path_to_mask": files["label_mask"],
            "path_to_indicator": files["indicator"],
            "size": np.array([h, w], np.int32),
            "origin_mask": origin_mask,
            "origin_label": origin_label,
            "active": active_indicator,
            "selected": active_selected,
        }
