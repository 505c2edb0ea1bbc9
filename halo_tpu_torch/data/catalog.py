"""Dataset catalog (the Cityscapes part of ``halo_tpu/data/catalog.py``)
and active-mask initialisation."""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

from .datasets import CityscapesDataSet
from .masks import init_image_mask


class DatasetCatalog:
    DATASET_DIR = "datasets"
    DATASETS = {
        "cityscapes_train": {"data_dir": "cityscapes",
                             "data_list": "cityscapes_train_list.txt"},
    }

    @staticmethod
    def dataset_dir(cfg=None) -> str:
        env = os.environ.get("HALO_DATASET_DIR")
        if env:
            return env
        if cfg is not None and hasattr(cfg, "TPU"):
            return cfg.TPU.DATASET_DIR
        return DatasetCatalog.DATASET_DIR

    @staticmethod
    def get(name, mode, num_classes, transform=None, cfg=None):
        if name not in DatasetCatalog.DATASETS:
            raise NotImplementedError(
                f"Dataset {name!r} is not ported yet (ROADMAP.md Queue 1 "
                "items 11-12); the port reads cityscapes.")
        attrs = DatasetCatalog.DATASETS[name]
        data_dir = DatasetCatalog.dataset_dir(cfg)
        return CityscapesDataSet(
            os.path.join(data_dir, attrs["data_dir"]),
            os.path.join(data_dir, attrs["data_list"]),
            save_dir=cfg.SAVE_DIR, num_classes=num_classes, split=mode,
            transform=transform)

    @staticmethod
    def init_mask(cfg, workers: int = 16):
        """Write 255-filled mask PNGs + scalar indicators for every target
        train image."""
        target = cfg.DATASETS.TARGET_TRAIN or "cityscapes_train"
        ds = DatasetCatalog.get(target, "train",
                                num_classes=cfg.MODEL.NUM_CLASSES, cfg=cfg)

        def one(files):
            init_image_mask(files["img"], files["label_mask"],
                            files["indicator"])

        with ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(one, ds.data_list))
