"""Dataset, transform and loader factories for the acquisition sweep
(the 'active' mode of ``halo_tpu/data/build.py``)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
from torch.utils.data import DataLoader

from . import transforms as T
from .catalog import DatasetCatalog


def build_transform(cfg, mode):
    """The eval transform (native-resolution labels), which the 'active'
    mode uses; the train transforms are a later slice."""
    if mode == "train":
        raise NotImplementedError(
            "train transforms are not ported yet (ROADMAP.md Queue 1 "
            "item 5)")
    w, h = cfg.INPUT.INPUT_SIZE_TEST
    return T.Compose([
        T.Resize((h, w), resize_label=False),
        T.ToArray(),
        T.Normalize(mean=cfg.INPUT.PIXEL_MEAN, std=cfg.INPUT.PIXEL_STD,
                    to_bgr255=cfg.INPUT.TO_BGR255),
    ])


def build_dataset(cfg, mode="active"):
    """The target set in 'active' mode: one pass over the target train
    list with the eval transform."""
    if mode != "active":
        raise NotImplementedError(
            f"build_dataset(mode={mode!r}) is not ported yet (ROADMAP.md "
            "Queue 1 items 5 and 9)")
    return DatasetCatalog.get(
        cfg.DATASETS.TARGET_TRAIN, mode, num_classes=cfg.MODEL.NUM_CLASSES,
        transform=build_transform(cfg, mode), cfg=cfg)


def numpy_collate(samples: List[Dict]) -> Dict:
    """Stack numpy arrays of one shape; keep everything else, and arrays
    whose shapes differ across the batch (native-resolution fields of a
    mixed-size set), as per-sample lists."""
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        first = vals[0]
        if isinstance(first, np.ndarray) and all(
                v.shape == first.shape for v in vals[1:]):
            out[key] = np.stack(vals)
        else:
            out[key] = vals
    return out


def build_active_loader(cfg, num_workers=None) -> DataLoader:
    """The acquisition sweep's loader: ``TPU.ACTIVE_BATCH`` images a
    batch, in file order, numpy batches."""
    workers = (int(cfg.TPU.LOADER_WORKERS) if num_workers is None
               else num_workers)
    return DataLoader(build_dataset(cfg, "active"),
                      batch_size=int(cfg.TPU.ACTIVE_BATCH), shuffle=False,
                      num_workers=workers, collate_fn=numpy_collate)
