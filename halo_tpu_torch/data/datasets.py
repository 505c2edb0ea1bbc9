"""Datasets: the GTAV and SYNTHIA source sets and the Cityscapes target
set with the active-mask protocol (copy of
``halo_tpu/data/datasets.py:56-322``; ACDC, a Cityscapes target set in
another layout, is in ``acdc.py``).

Samples are dicts of numpy arrays and strings, channel-last. A train-mode
Cityscapes sample carries its label and its active mask (read from the
in-process cache first, then from disk) through the transforms as one
(H, W, 2) map; in 'active' mode it also carries the native-resolution
label, mask and active/selected indicators. ``__getitem__`` takes the
``random.Random`` of the sample, which the train transforms draw from.

Label maps (``label``, ``mask``, ``origin_label``, ``origin_mask``) are
uint8 here, where the JAX copy widens them to int32: the values are the
same (0-255), and a loader worker ships a sample to the main process in
~20 MB instead of ~48 MB at 1024x2048.
"""

from __future__ import annotations

import os
import os.path as osp
import pickle
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

TRAINID2NAME_19 = {0: "road", 1: "sidewalk", 2: "building", 3: "wall",
                   4: "fence", 5: "pole", 6: "light", 7: "sign",
                   8: "vegetation", 9: "terrain", 10: "sky", 11: "person",
                   12: "rider", 13: "car", 14: "truck", 15: "bus",
                   16: "train", 17: "motocycle", 18: "bicycle"}
TRAINID2NAME_16 = {0: "road", 1: "sidewalk", 2: "building", 3: "wall",
                   4: "fence", 5: "pole", 6: "light", 7: "sign",
                   8: "vegetation", 9: "sky", 10: "person", 11: "rider",
                   12: "car", 13: "bus", 14: "motocycle", 15: "bicycle"}


def remap_labels(label: np.ndarray, num_classes: int,
                 ignore_label: int = 255) -> np.ndarray:
    """Vectorized id->trainid remap via a 256-entry LUT."""
    table = np.full(256, ignore_label, np.uint8)
    mapping = ID_TO_TRAINID_16 if num_classes == 16 else ID_TO_TRAINID_19
    for k, v in mapping.items():
        table[k] = v
    return table[label]


def _repeat_to(lst, max_iters):
    """``lst`` repeated to at least ``max_iters`` entries."""
    if max_iters is None or not lst:
        return lst
    return lst * int(np.ceil(float(max_iters) / len(lst)))


def balanced_file_list(label_to_file, file_to_label, num_classes, max_iters,
                       seed=0, sub_epoch_size=3000):
    """Inverse-log-frequency class-balanced resampling of the source list,
    from a ``np.random.RandomState(seed)``: the same draws as the JAX
    package's copy. Classes with no files are left out of the draw."""
    rng = np.random.RandomState(seed)
    label_to_file = [list(v) for v in label_to_file]
    ind = {i: 0 for i in range(num_classes)}
    has_files = np.array([len(v) > 0 for v in label_to_file], bool)
    if not has_files.any():
        raise ValueError("label-info has no files for any class")
    out = []
    for _e in range(int(max_iters / sub_epoch_size) + 1):
        dist = np.zeros(num_classes)
        for _i in range(sub_epoch_size):
            dist1 = dist.copy() if dist.sum() == 0 else dist / dist.sum()
            w = 1.0 / np.log(1 + 1e-2 + dist1)
            w = np.where(has_files, w, 0.0)
            w = w / w.sum()
            c = rng.choice(num_classes, p=w)
            if ind[c] > (len(label_to_file[c]) - 1):
                rng.shuffle(label_to_file[c])
                ind[c] = ind[c] % len(label_to_file[c])
            c_file = label_to_file[c][ind[c]]
            out.append(c_file)
            ind[c] += 1
            dist[file_to_label[c_file]] += 1
    return out


class _SourceDataset:
    """A source set: ``images/<name>`` and ``<label_subdir>/<name>`` under
    the data root. With ``max_iters`` the list is the class-balanced
    resampling over the set's label-info pickle, repeated to
    ``max_iters``."""

    label_info_name = ""
    label_subdir = "labels"

    def __init__(self, data_root, data_list, max_iters=None, num_classes=19,
                 split="train", transform=None, ignore_label=255, seed=0):
        self.split = split
        self.num_classes = num_classes
        self.data_root = data_root
        self.transform = transform
        self.ignore_label = ignore_label
        with open(data_list) as handle:
            img_ids = [line.strip() for line in handle if line.strip()]
        if max_iters is not None:
            # The class-frequency table: next to the data, next to the list,
            # then the copy committed under <repo>/datasets/.
            candidates = [
                osp.join(data_root, self.label_info_name),
                osp.join(osp.dirname(osp.abspath(data_list)),
                         self.label_info_name),
                osp.join(osp.dirname(osp.dirname(osp.dirname(
                    osp.abspath(__file__)))), "datasets",
                    self.label_info_name),
            ]
            info = next((c for c in candidates if osp.exists(c)),
                        candidates[0])
            with open(info, "rb") as handle:
                label_to_file, file_to_label = pickle.load(handle)
            img_ids = balanced_file_list(label_to_file, file_to_label,
                                         num_classes, max_iters, seed=seed)
        self.data_list: List[Dict] = [
            {"img": os.path.join(data_root, "images", name),
             "label": os.path.join(data_root, self.label_subdir, name),
             "name": name} for name in img_ids]
        if max_iters is not None:
            self.data_list = _repeat_to(self.data_list, max_iters)

    def __len__(self):
        return len(self.data_list)

    def _read_label(self, path) -> np.ndarray:
        return np.asarray(Image.open(path), dtype=np.uint8)

    def __getitem__(self, index, rng=None):
        files = self.data_list[index]
        image = Image.open(files["img"]).convert("RGB")
        label = remap_labels(self._read_label(files["label"]),
                             self.num_classes, self.ignore_label)
        label = Image.fromarray(label)
        if self.transform is not None:
            image, label = self.transform(image, label, rng)
        return {"img": image, "label": np.asarray(label), "index": index,
                "name": files["name"]}


class GTAVDataSet(_SourceDataset):
    """GTAV: 8-bit label-id PNGs under ``labels/``."""

    label_info_name = "gtav_label_info.p"


class SynthiaDataSet(_SourceDataset):
    """SYNTHIA: 16-bit label PNGs under ``GT/LABELS/`` whose semantic id is
    channel 0 (the instance id rides in channel 1)."""

    label_info_name = "synthia_label_info.p"
    label_subdir = "GT/LABELS"

    def _read_label(self, path) -> np.ndarray:
        arr = np.asarray(Image.open(path))
        if arr.ndim == 3:
            arr = arr[..., 0]
        return arr.astype(np.uint8)


class CityscapesDataSet:
    """Cityscapes target set with the active-mask protocol. ``load_mask``
    False (a Cityscapes source) reads no mask store; ``max_iters`` repeats
    the list."""

    def __init__(self, data_root, data_list, save_dir, max_iters=None,
                 num_classes=19, split="train", transform=None,
                 ignore_label=255, load_mask=True):
        self.active = split == "active"
        if split == "active":
            split = "train"
        self.split = split
        self.num_classes = num_classes
        self.data_root = data_root
        self.save_dir = save_dir
        self.transform = transform
        self.ignore_label = ignore_label
        self.load_mask = load_mask

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
        self.data_list = _repeat_to(self.data_list, max_iters)

    def __len__(self):
        return len(self.data_list)

    def native_size(self, index) -> tuple:
        """Native (H, W) of sample ``index`` from its image file's header
        (no pixel decode): the sweep loader groups its batches by it."""
        with Image.open(self.data_list[index]["img"]) as im:
            w, h = im.size
        return h, w

    def __getitem__(self, index, rng=None):
        files = self.data_list[index]
        image = Image.open(files["img"]).convert("RGB")
        label = np.asarray(Image.open(files["label"]), dtype=np.uint8)
        if self.split == "train" and self.load_mask:
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
            image, pair = self.transform(image, pair, rng)
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
