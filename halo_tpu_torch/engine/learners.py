"""Learners: the training runtime over the step library (port of
``halo_tpu/engine/learners.py``: ``Learner`` :49-413, ``_ActiveMixin``
:425-562, ``SourceTargetLearner`` :578-585, ``build_learner`` :825).

One device. A ``Learner`` owns the model (in train mode; FrozenBatchNorm
stays frozen), the two-group SGD and its schedule, the loaders, the
validation cadence, checkpoints and ``metrics.jsonl``; ``_ActiveMixin``
runs the acquisition rounds at ``ACTIVE.SELECT_ITER``. Only the
``source_target`` protocol has a learner so far.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..active.region_selection import region_selection
from ..data.build import (build_active_loader, build_test_loader,
                          build_train_loader)
from ..data.catalog import DatasetCatalog
from ..device import resolve_device
from ..models import build_segmentor
from ..utils.metrics import miou_from_histograms
from .optim import build_optimizer
from .state import load_module_params, save_checkpoint
from .steps import make_eval_step, make_train_step


class Learner:
    """Shared runtime of the protocols.

    ``fit(stage_seconds=...)``, when given a dict, synchronises the device
    at stage boundaries and adds the seconds of 'load' (waiting for the
    loaders and the host-to-device copies), 'step' (forwards, losses,
    backward, optimizer), 'log', 'round' (acquisition) and 'validate' to it;
    ``step_seconds`` then lists each step's (load, step) seconds."""

    protocol: str = "source"
    # Only these batch fields go to the device.
    _TRAIN_KEYS = ("img", "label", "mask")

    def __init__(self, cfg, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.debug = bool(cfg.DEBUG)
        self.num_devices = 1
        self.seed = (int(cfg.SEED) if cfg.SEED >= 0
                     else int(time.time()) % (2 ** 31))
        if cfg.MODEL.WEIGHTS:
            raise NotImplementedError(
                "MODEL.WEIGHTS: loading pretrained weights is not ported yet "
                "(ROADMAP.md Queue 1 item 3); pass MODEL.WEIGHTS \"\" to "
                "start from the seeded random init")
        self.model = build_segmentor(
            cfg, device=self.device,
            generator=torch.Generator().manual_seed(self.seed))
        if cfg.resume:
            load_module_params(self.model, cfg.resume, "feature_extractor")
            load_module_params(self.model, cfg.resume, "classifier")
        self.model.train()
        self.optimizer, self.scheduler, self._lr_at = build_optimizer(
            cfg, self.model, self.num_devices)
        self.train_step = make_train_step(cfg, self.model, self.optimizer,
                                          self.protocol)
        self.eval_step = make_eval_step(cfg, self.model)
        self.step = 0
        self.history: List[Dict] = []
        self.best_miou = -1.0
        self.active_round = 1
        self.step_seconds: List[tuple] = []

    # -- data ---------------------------------------------------------------

    def train_loaders(self):
        raise NotImplementedError

    def _loader(self, is_source: bool):
        return build_train_loader(self.cfg, is_source, self.global_batch(),
                                  self.seed)

    def global_batch(self) -> int:
        return self.cfg.SOLVER.BATCH_SIZE * self.num_devices

    def num_steps(self) -> int:
        return self.cfg.SOLVER.NUM_ITER // self.num_devices

    def _to_device(self, batch: Dict) -> Dict:
        out = {}
        for k in self._TRAIN_KEYS:
            if k in batch:
                t = torch.as_tensor(batch[k]).to(self.device,
                                                 non_blocking=True)
                out[k] = t if k == "img" else t.long()
        return out

    def on_batch_start(self, step: int) -> bool:
        """True when an acquisition round ran before ``step``."""
        return False

    # -- logging and checkpoints -------------------------------------------

    def log(self, step: int, metrics: Dict, active_round: int = None):
        """One ``metrics.jsonl`` record: the step, its loss terms, both
        groups' LR at the step and the acquisition round it ran in."""
        if active_round is None:
            active_round = self.active_round
        rec = {"step": step, **{k: float(v) for k, v in metrics.items()},
               **self._lr_at(step), "active_round": int(active_round)}
        self.history.append(rec)
        if step % 50 == 0 or self.debug:
            msg = " ".join(f"{k}={v:.4g}" for k, v in rec.items()
                           if k != "step")
            print(f"[{self.protocol}] step {step}: {msg}", flush=True)
        self._append_jsonl(rec)

    def _append_jsonl(self, rec):
        os.makedirs(self.cfg.SAVE_DIR, exist_ok=True)
        with open(os.path.join(self.cfg.SAVE_DIR, "metrics.jsonl"),
                  "a") as f:
            f.write(json.dumps(rec) + "\n")

    def _save_checkpoint(self, filename: str, extra: Optional[Dict] = None):
        blob = {"active_round": int(self.active_round),
                "best_miou": float(self.best_miou)}
        blob.update(extra or {})
        save_checkpoint(self.model, os.path.join(self.cfg.SAVE_DIR, filename),
                        optimizer=self.optimizer, step=self.step, extra=blob)

    # -- loops --------------------------------------------------------------

    def fit(self, max_steps: Optional[int] = None, val_interval: int = 500,
            stage_seconds: Optional[Dict[str, float]] = None):
        """Train to ``max_steps`` (default ``NUM_ITER``), validating every
        ``val_interval`` steps (0: never) and keeping ``best_mIoU.ckpt``;
        writes ``last.ckpt`` at the end. Logging runs one step late, so the
        host reads a step's losses only after the next step is queued."""
        loaders = self.train_loaders()
        epochs = {k: 0 for k in loaders}

        def fresh(k):
            loaders[k].batch_sampler.set_epoch(epochs[k])
            return iter(loaders[k])

        iters = {k: fresh(k) for k in loaders}
        steps = max_steps or self.num_steps()
        clock = {"t": time.perf_counter()}

        def lap(stage):
            if stage_seconds is None:
                return None
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            now = time.perf_counter()
            spent = now - clock["t"]
            stage_seconds[stage] = stage_seconds.get(stage, 0.0) + spent
            clock["t"] = now
            return spent

        pending = None
        for step in range(self.step, steps):
            if self.on_batch_start(step):
                # masks changed on disk: start a fresh epoch of every loader
                for k in loaders:
                    epochs[k] += 1
                    iters[k] = fresh(k)
            lap("round")
            batches = {}
            for k in loaders:
                try:
                    batch = next(iters[k])
                except StopIteration:
                    epochs[k] += 1
                    iters[k] = fresh(k)
                    batch = next(iters[k])
                batches[k] = self._to_device(batch)
            load = lap("load")
            metrics = self.train_step(batches)
            self.scheduler.step()
            self.step = step + 1
            if stage_seconds is not None:
                self.step_seconds.append((load, lap("step")))
            if pending is not None:
                self.log(*pending)
            pending = (step, metrics, self.active_round)
            lap("log")
            if val_interval and (step + 1) % val_interval == 0:
                self.log(*pending)
                pending = None
                miou = self.validate()
                if miou > self.best_miou:
                    self.best_miou = miou
                    self._save_checkpoint("best_mIoU.ckpt",
                                          extra={"mIoU": miou, "step": step})
                lap("validate")
        if pending is not None:
            self.log(*pending)
        self._save_checkpoint("last.ckpt")
        return self.history

    def validate(self, loader=None, max_batches: Optional[int] = None
                 ) -> float:
        """Flip-TTA mIoU (in %) over the validation set, in eval mode;
        appends mIoU, mAcc and aAcc to ``metrics.jsonl``."""
        loader = loader or build_test_loader(self.cfg)
        self.model.eval()
        inter = union = target = None
        try:
            for i, batch in enumerate(loader):
                if max_batches is not None and i >= max_batches:
                    break
                img = torch.as_tensor(batch["img"]).to(self.device)
                label = torch.as_tensor(np.asarray(batch["label"])).to(
                    self.device).long()
                it, un, tg = self.eval_step(img, label, flip=True)
                if inter is None:
                    inter, union, target = it, un, tg
                else:
                    inter, union, target = inter + it, union + un, target + tg
        finally:
            self.model.train()
        if inter is None:
            return 0.0
        miou, macc, aacc, _, _ = miou_from_histograms(
            inter.cpu(), union.cpu(), target.cpu())
        miou, macc, aacc = (float(v) * 100 for v in (miou, macc, aacc))
        print(f"\nmIoU: {miou:.2f}\nmAcc: {macc:.2f}\naAcc: {aacc:.2f}\n",
              flush=True)
        self._append_jsonl({"mIoU": miou, "mAcc": macc, "aAcc": aacc})
        return miou


class _ActiveMixin:
    """Acquisition rounds at ``ACTIVE.SELECT_ITER``."""

    def _init_active(self):
        self.active_loader = build_active_loader(self.cfg)
        print(">>>>>>>>>>>>>>>> Init Mask >>>>>>>>>>>>>>>>", flush=True)
        DatasetCatalog.init_mask(self.cfg)
        self.active_iters = [int(x / self.num_devices)
                             for x in self.cfg.ACTIVE.SELECT_ITER]
        print(f"\nActive learning at iters: {self.active_iters}\n",
              flush=True)

    def on_batch_start(self, step: int) -> bool:
        if step not in self.active_iters or self.debug:
            return False
        name = f"model_before_round_{self.active_round}.ckpt"
        print(f"\nSaving checkpoint: {name}", flush=True)
        self._save_checkpoint(name)
        print(f"\n>>>> Active Round {self.active_round} >>>>", flush=True)
        self.model.eval()
        try:
            stats = region_selection(self.cfg, self.model, self.active_loader,
                                     self.active_round, device=self.device)
        finally:
            self.model.train()
        print(f"  selected {stats['picked']} regions / "
              f"{stats['labeled_px']} px over {stats['images']} images",
              flush=True)
        self.active_round += 1
        return True


class SourceTargetLearner(_ActiveMixin, Learner):
    """Source CE + target active CE + LCR + negative learning, with
    acquisition rounds on the target set."""

    protocol = "source_target"

    def __init__(self, cfg, device=None):
        super().__init__(cfg, device=device)
        self._init_active()

    def train_loaders(self):
        return {"source": self._loader(True), "target": self._loader(False)}


PROTOCOLS = {"source_target": SourceTargetLearner}


def build_learner(cfg, device=None) -> Learner:
    """The learner of ``cfg.PROTOCOL`` on ``device`` (CUDA unless the
    caller passes another)."""
    if cfg.PROTOCOL not in PROTOCOLS:
        raise NotImplementedError(
            f"Protocol {cfg.PROTOCOL!r} has no learner in the port yet "
            "(ROADMAP.md Queue 1 item 11); the port trains source_target.")
    return PROTOCOLS[cfg.PROTOCOL](cfg, device=device)
