"""Dataset, transform and loader factories (port of
``halo_tpu/data/build.py`` and of the sampling of
``halo_tpu/data/loader.py``).

Loaders are ``torch.utils.data.DataLoader``s over numpy samples. A train
loader draws its batches from ``EpochBatchSampler``, which reproduces the
JAX package's loader: epoch ``e`` shuffles with
``random.Random(f"{seed}-{e}")``, sample ``i`` of epoch ``e`` is transformed
with ``random.Random(f"{seed}-{e}-{i}")`` whatever the worker count, and a
trailing partial batch is dropped. Both packages' learners therefore see
the same batches.
"""

from __future__ import annotations

import random
from typing import Dict, List

import numpy as np
from torch.utils.data import DataLoader, Dataset

from . import transforms as T
from .catalog import DatasetCatalog


def build_transform(cfg, mode, is_source=False):
    """'train': resize image and label to the domain's train size (or, with
    ``INPUT.INPUT_SCALES_TRAIN`` other than (1, 1), random scale and crop),
    then normalise. Other modes: resize the image to ``INPUT_SIZE_TEST``
    and keep native-resolution labels."""
    norm = [T.ToArray(),
            T.Normalize(mean=cfg.INPUT.PIXEL_MEAN, std=cfg.INPUT.PIXEL_STD,
                        to_bgr255=cfg.INPUT.TO_BGR255)]
    if mode == "train":
        w, h = (cfg.INPUT.SOURCE_INPUT_SIZE_TRAIN if is_source
                else cfg.INPUT.TARGET_INPUT_SIZE_TRAIN)
        scales = cfg.INPUT.INPUT_SCALES_TRAIN
        if scales[0] == scales[1] == 1:
            return T.Compose([T.Resize((h, w))] + norm)
        return T.Compose([T.RandomScale(scale=scales, size=(h, w)),
                          T.RandomCrop(size=(h, w), pad_if_needed=True)]
                         + norm)
    w, h = cfg.INPUT.INPUT_SIZE_TEST
    return T.Compose([T.Resize((h, w), resize_label=False)] + norm)


def build_dataset(cfg, mode="active", is_source=False, epochwise=False):
    """'train' and 'active': the source (``is_source``) or target train set,
    repeated to ``NUM_ITER * BATCH_SIZE`` samples unless ``epochwise``.
    'val': ``DATASETS.TEST`` in its val split; 'test': in the split its
    name ends with."""
    transform = build_transform(cfg, mode, is_source)
    seed = max(int(cfg.SEED), 0)
    if mode in ("train", "active"):
        iters = (None if epochwise
                 else cfg.SOLVER.NUM_ITER * cfg.SOLVER.BATCH_SIZE)
        name = (cfg.DATASETS.SOURCE_TRAIN if is_source
                else cfg.DATASETS.TARGET_TRAIN)
        return DatasetCatalog.get(
            name, mode, num_classes=cfg.MODEL.NUM_CLASSES, max_iters=iters,
            transform=transform, cfg=cfg, seed=seed, is_source=is_source)
    if mode in ("val", "test"):
        split = "val" if mode == "val" else cfg.DATASETS.TEST.split("_")[-1]
        return DatasetCatalog.get(
            cfg.DATASETS.TEST, split,
            num_classes=cfg.MODEL.NUM_CLASSES, transform=transform, cfg=cfg,
            seed=seed)
    raise NotImplementedError(f"build_dataset(mode={mode!r})")


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


class EpochBatchSampler:
    """Batches of ``(epoch, index)`` keys in the JAX loader's order: the
    epoch set by ``set_epoch`` (read when iteration starts), shuffled with
    ``random.Random(f"{seed}-{epoch}")``, cut into ``batch_size`` batches,
    the last dropped when short and ``drop_last``."""

    def __init__(self, n: int, batch_size: int, seed: int, shuffle=True,
                 drop_last=True):
        self.n, self.batch_size, self.seed = n, batch_size, seed
        self.shuffle, self.drop_last = shuffle, drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        if self.drop_last:
            return self.n // self.batch_size
        return (self.n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        epoch = self.epoch
        order = list(range(self.n))
        if self.shuffle:
            random.Random(f"{self.seed}-{epoch}").shuffle(order)
        for i in range(0, self.n, self.batch_size):
            batch = order[i:i + self.batch_size]
            if len(batch) < self.batch_size and self.drop_last:
                return
            yield [(epoch, j) for j in batch]


class SeededSamples(Dataset):
    """A dataset indexed by ``(epoch, index)``: sample ``index`` is read
    with its own ``random.Random(f"{seed}-{epoch}-{index}")``."""

    def __init__(self, dataset, seed: int):
        self.dataset, self.seed = dataset, seed

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, key):
        epoch, index = key
        return self.dataset.__getitem__(
            index, rng=random.Random(f"{self.seed}-{epoch}-{index}"))


def build_train_loader(cfg, is_source: bool, batch_size: int, seed: int,
                       num_workers=None) -> DataLoader:
    """The source or target train loader: shuffled, seeded per epoch and
    sample, last partial batch dropped; numpy batches. Call
    ``loader.batch_sampler.set_epoch(e)`` before iterating epoch ``e``."""
    dataset = build_dataset(cfg, "train", is_source=is_source)
    workers = (int(cfg.TPU.LOADER_WORKERS) if num_workers is None
               else num_workers)
    sampler = EpochBatchSampler(len(dataset), batch_size, seed)
    return DataLoader(SeededSamples(dataset, seed), batch_sampler=sampler,
                      num_workers=workers, collate_fn=numpy_collate)


def build_test_loader(cfg, num_workers=None) -> DataLoader:
    """The validation loader: ``DATASETS.TEST`` with the eval transform,
    ``TEST.BATCH_SIZE`` images a batch, in file order."""
    workers = (int(cfg.TPU.LOADER_WORKERS) if num_workers is None
               else num_workers)
    return DataLoader(build_dataset(cfg, "test"),
                      batch_size=int(cfg.TEST.BATCH_SIZE), shuffle=False,
                      num_workers=workers, collate_fn=numpy_collate)


class SizeGroupedBatches:
    """The sweep's batches of ``batch_size`` indices in the JAX loader's
    order (``group_by_size``): with more than one image a batch, the
    indices are bucketed by native size (buckets in order of first
    appearance, file order within one) and each bucket is cut into
    batches, its last one possibly short; with one a batch, file order.
    Batch ``n``'s image ``b`` is then image ``n * batch_size + b`` of the
    JAX package's sweep, whose short batches are padded at their end."""

    def __init__(self, dataset, batch_size: int):
        buckets: Dict[tuple, List[int]] = {}
        for i in range(len(dataset)):
            key = tuple(dataset.native_size(i)) if batch_size > 1 else ()
            buckets.setdefault(key, []).append(i)
        self.batches = [bucket[i:i + batch_size]
                        for bucket in buckets.values()
                        for i in range(0, len(bucket), batch_size)]

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)


def build_active_loader(cfg, num_workers=None) -> DataLoader:
    """The acquisition sweep's loader: ``TPU.ACTIVE_BATCH`` images a
    batch, grouped by native size (``SizeGroupedBatches``), numpy
    batches."""
    workers = (int(cfg.TPU.LOADER_WORKERS) if num_workers is None
               else num_workers)
    dataset = build_dataset(cfg, "active", epochwise=True)
    return DataLoader(dataset, batch_sampler=SizeGroupedBatches(
        dataset, int(cfg.TPU.ACTIVE_BATCH)), num_workers=workers,
        collate_fn=numpy_collate)
