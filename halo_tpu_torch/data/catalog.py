"""Dataset catalog (copy of ``halo_tpu/data/catalog.py``: GTAV, SYNTHIA,
Cityscapes and ACDC) and active-mask initialisation."""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

from .acdc import ACDCDataSet
from .datasets import CityscapesDataSet, GTAVDataSet, SynthiaDataSet
from .masks import init_image_mask


class DatasetCatalog:
    DATASET_DIR = "datasets"
    DATASETS = {
        "gtav_train": {"data_dir": "gtav", "data_list": "gtav_train_list.txt"},
        "synthia_train": {"data_dir": "synthia",
                          "data_list": "synthia_train_list.txt"},
        "cityscapes_train": {"data_dir": "cityscapes",
                             "data_list": "cityscapes_train_list.txt"},
        "cityscapes_val": {"data_dir": "cityscapes",
                           "data_list": "cityscapes_val_list.txt"},
        "acdc_train": {"data_dir": "acdc",
                       "data_list": "acdc_train_list.txt"},
        "acdc_val": {"data_dir": "acdc", "data_list": "acdc_val_list.txt"},
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
    def get(name, mode, num_classes, max_iters=None, transform=None,
            cfg=None, seed=0, is_source=False):
        """The dataset ``name`` in ``mode`` ('train', 'active', 'val').
        A Cityscapes or ACDC set used as the source reads full labels and
        no mask store."""
        if name not in DatasetCatalog.DATASETS:
            raise RuntimeError(f"Dataset not available: {name}")
        attrs = DatasetCatalog.DATASETS[name]
        data_dir = DatasetCatalog.dataset_dir(cfg)
        root = os.path.join(data_dir, attrs["data_dir"])
        data_list = os.path.join(data_dir, attrs["data_list"])
        source = {"gtav": GTAVDataSet, "synthia": SynthiaDataSet}.get(
            name.split("_")[0])
        if source is not None:
            return source(root, data_list, max_iters=max_iters,
                          num_classes=num_classes, split=mode,
                          transform=transform, seed=seed)
        target = ACDCDataSet if name.startswith("acdc") else CityscapesDataSet
        return target(
            root, data_list, save_dir=cfg.SAVE_DIR, max_iters=max_iters,
            num_classes=num_classes, split=mode, transform=transform,
            load_mask=not is_source)

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
