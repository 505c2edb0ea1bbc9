"""ACDC, the adverse-condition target set in Cityscapes' label space (copy
of ``halo_tpu/data/acdc.py``).

ACDC keeps Cityscapes' 19-class labelIds format in its own layout:

    rgb_anon/<condition>/<split>/<seq>/<frame>_rgb_anon.png
    gt/<condition>/<split>/<seq>/<frame>_gt_labelIds.png

with condition one of fog, night, rain, snow. A list-file line is
``<condition>/<seq>/<frame>_rgb_anon.png``; the dataset inserts the
split. The active-mask store keys on the whole stem, condition included
(fog and night share frame names): ``gtMask/<split>/<stem>_gt_labelIds.png``
and ``gtIndicator/train/<stem with / as _>_indicator.pth``. Samples,
masks and transforms are the Cityscapes target set's.
"""

from __future__ import annotations

import os
from typing import Dict, List

from .datasets import CityscapesDataSet, _repeat_to


class ACDCDataSet(CityscapesDataSet):
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
            condition, rest = name.split("/", 1)
            stem = name.split("_rgb_anon")[0]
            stem_rest = rest.split("_rgb_anon")[0]
            self.data_list.append({
                "img": os.path.join(
                    data_root, f"rgb_anon/{condition}/{self.split}/{rest}"),
                "label": os.path.join(
                    data_root, f"gt/{condition}/{self.split}/"
                    f"{stem_rest}_gt_labelIds.png"),
                "label_mask": os.path.join(
                    save_dir, f"gtMask/{self.split}/{stem}_gt_labelIds.png"),
                "indicator": os.path.join(
                    save_dir, f"gtIndicator/train/"
                    f"{stem.replace('/', '_')}_indicator.pth"),
                "name": name,
            })
        self.data_list = _repeat_to(self.data_list, max_iters)
