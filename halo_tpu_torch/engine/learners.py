"""Learners: the training runtime over the step library (port of
``halo_tpu/engine/learners.py``: ``Learner`` :49-413, ``SourceLearner``
:416, ``_ActiveMixin`` :425-562, ``SourceFreeLearner`` :565,
``SourceTargetLearner`` :578, ``FullySupervisedLearner`` :588,
``TestLearner`` :631-813 without int8, ``build_learner`` :825).

One device. A ``Learner`` owns the model (in train mode; FrozenBatchNorm
stays frozen), the two-group SGD and its schedule, the loaders, the
validation cadence, checkpoints, ``metrics.jsonl``, ``resume_full`` and
preemption; ``_ActiveMixin`` runs the acquisition rounds at
``ACTIVE.SELECT_ITER``. The protocols differ in their loaders and loss
stack:

  source        -> SourceLearner           (source loader)
  source_free   -> SourceFreeLearner       (target loader, rounds)
  source_target -> SourceTargetLearner     (both loaders, rounds)
  fully_sup     -> FullySupervisedLearner  (both loaders, GT labels)
  test          -> TestLearner             (evaluation only)
"""

from __future__ import annotations

import json
import os
import signal
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..active.region_selection import region_selection
from ..data.build import (build_active_loader, build_test_loader,
                          build_train_loader)
from ..data.catalog import DatasetCatalog
from ..data.datasets import TRAINID2NAME_16, TRAINID2NAME_19
from ..device import resolve_device
from ..models import build_segmentor
from ..models.pretrained import load_pretrained_backbone
from ..utils.metrics import miou_from_histograms, miou_star
from .optim import build_optimizer
from .state import load_module_params, restore_state, save_checkpoint
from .steps import make_eval_step, make_rich_eval_step, make_train_step


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
        self.model = build_segmentor(
            cfg, device=self.device,
            generator=torch.Generator().manual_seed(self.seed))
        # The pretrained trunk (MODEL.WEIGHTS) first; ``resume`` then
        # replaces each module its checkpoint holds.
        load_pretrained_backbone(self.model, cfg.MODEL.WEIGHTS)
        if cfg.resume:
            for module in ("feature_extractor", "classifier"):
                load_module_params(self.model, cfg.resume, module)
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
        """Model, optimizer, step and the learner's counters
        (``active_round``, ``best_miou``) in ``SAVE_DIR/filename``."""
        blob = {"active_round": int(self.active_round),
                "best_miou": float(self.best_miou)}
        blob.update(extra or {})
        save_checkpoint(self.model, os.path.join(self.cfg.SAVE_DIR, filename),
                        optimizer=self.optimizer, step=self.step, extra=blob)

    def resume_full(self, path: str) -> int:
        """Restore the whole trainer from a checkpoint of this learner:
        model, optimizer, the LR schedule, the step and the counters, so
        ``fit`` continues where the run stopped and neither renumbers the
        rounds (``model_before_round_<k>.ckpt``) nor lets a worse mIoU
        replace ``best_mIoU.ckpt``. Returns the step."""
        blob = restore_state(self.model, self.optimizer, self.scheduler,
                             path)
        self.step = int(blob["step"])
        extra = blob.get("extra") or {}
        if "active_round" in extra:
            self.active_round = int(extra["active_round"])
        if "best_miou" in extra:
            self.best_miou = float(extra["best_miou"])
        return self.step

    # -- loops --------------------------------------------------------------

    def fit(self, max_steps: Optional[int] = None, val_interval: int = 500,
            stage_seconds: Optional[Dict[str, float]] = None):
        """Train from ``self.step`` to ``max_steps`` (default ``NUM_ITER``),
        validating every ``val_interval`` steps (0: never) and keeping
        ``best_mIoU.ckpt``; writes ``last.ckpt`` at the end. Logging runs
        one step late, so the host reads a step's losses only after the
        next step is queued.

        On SIGTERM or SIGINT the step under way finishes, ``preempt.ckpt``
        is written before the next one and the loop ends (``last.ckpt``
        as ever); ``resume_full(preempt.ckpt)`` continues the run. The
        handlers in place before are restored on the way out."""
        preempted = []

        def on_signal(signum, _frame):
            print(f"signal {signum}: checkpointing for preemption...",
                  flush=True)
            preempted.append(signum)

        old_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                old_handlers[sig] = signal.signal(sig, on_signal)
            except ValueError:  # not the main thread: no handlers
                pass
        try:
            return self._fit(max_steps, val_interval, stage_seconds,
                             preempted)
        finally:
            for sig, handler in old_handlers.items():
                signal.signal(sig, handler)

    def _fit(self, max_steps, val_interval, stage_seconds, preempted):
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
            if preempted:
                self._save_checkpoint("preempt.ckpt")
                print(f"preempted at step {step}; state saved", flush=True)
                break
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
        sums = self._eval_sums(loader or build_test_loader(self.cfg),
                               max_batches)
        if sums[0] is None:
            return 0.0
        miou, macc, aacc, _, _ = miou_from_histograms(
            *(t.cpu() for t in sums))
        miou, macc, aacc = (float(v) * 100 for v in (miou, macc, aacc))
        print(f"\nmIoU: {miou:.2f}\nmAcc: {macc:.2f}\naAcc: {aacc:.2f}\n",
              flush=True)
        self._append_jsonl({"mIoU": miou, "mAcc": macc, "aAcc": aacc})
        return miou

    def _eval_sums(self, loader, max_batches: Optional[int] = None):
        """The (inter, union, target) sums of the flip-TTA eval step over
        ``loader``'s first ``max_batches`` batches, in eval mode."""
        sums = (None, None, None)
        self.model.eval()
        try:
            for i, batch in enumerate(loader):
                if max_batches is not None and i >= max_batches:
                    break
                sums = _accumulate(sums, self.eval_step(
                    *self._eval_batch(batch), flip=True))
        finally:
            self.model.train()
        return sums

    def _eval_batch(self, batch):
        """A loader batch's image and label on the device."""
        img = torch.as_tensor(batch["img"]).to(self.device)
        label = torch.as_tensor(np.asarray(batch["label"])).to(
            self.device).long()
        return img, label


class _ActiveMixin:
    """Acquisition rounds at ``ACTIVE.SELECT_ITER``."""

    def _init_active(self):
        if bool(self.cfg.TPU.QUANT_SWEEP):
            raise NotImplementedError(
                "TPU.QUANT_SWEEP: the int8 W8A8 acquisition sweep is not "
                "ported yet (ROADMAP.md Queue 1 item 13)")
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


class SourceLearner(Learner):
    """Source CE alone: pretraining on the source set."""

    protocol = "source"

    def train_loaders(self):
        return {"source": self._loader(True)}


class SourceFreeLearner(_ActiveMixin, Learner):
    """Target active CE + negative learning, with acquisition rounds on the
    target set; no source data."""

    protocol = "source_free"

    def __init__(self, cfg, device=None):
        super().__init__(cfg, device=device)
        self._init_active()

    def train_loaders(self):
        return {"target": self._loader(False)}


class SourceTargetLearner(SourceFreeLearner):
    """Source CE + target active CE + LCR + negative learning, with
    acquisition rounds on the target set."""

    protocol = "source_target"

    def train_loaders(self):
        return {"source": self._loader(True), "target": self._loader(False)}


class FullySupervisedLearner(SourceTargetLearner):
    """GT labels on both domains, no acquisition: the upper bound. The
    target loader still reads mask files, so they are initialised."""

    protocol = "fully_sup"

    def __init__(self, cfg, device=None):
        Learner.__init__(self, cfg, device=device)
        DatasetCatalog.init_mask(cfg)
        self.active_iters = []

    def on_batch_start(self, step: int) -> bool:
        return False


class TestLearner(Learner):
    """Evaluation only: ``test()`` scores ``DATASETS.TEST`` with flip-TTA
    and, with ``TEST.SAVE_EMBED`` or ``TEST.VIZ_WRONG``, saves each image's
    tensors under ``SAVE_DIR/embed`` and plots wrong predictions under
    ``SAVE_DIR/viz/wrong``."""

    protocol = "test"

    def __init__(self, cfg, device=None):
        if bool(cfg.TPU.QUANT_EVAL):
            raise NotImplementedError(
                "TPU.QUANT_EVAL: int8 W8A8 evaluation is not ported yet "
                "(ROADMAP.md Queue 1 item 13)")
        super().__init__(cfg, device=device)

    def train_loaders(self):
        raise RuntimeError("TestLearner does not train")

    def test(self, max_batches: Optional[int] = None) -> Dict:
        """{'mIoU', 'mAcc', 'aAcc', 'iou_class'} in %, plus 'mIoU*' (13
        classes) at 16 classes; prints the per-class table and the LaTeX
        row."""
        cfg = self.cfg
        if cfg.TEST.SAVE_EMBED or cfg.TEST.VIZ_WRONG:
            inter, union, target = self._test_rich(max_batches)
        else:
            inter, union, target = self._eval_sums(build_test_loader(cfg),
                                                   max_batches)
        if inter is None:
            raise RuntimeError(
                "test(): the eval loader yielded no batches "
                "(empty val split or max_batches=0)")
        miou, macc, aacc, iou_c, _ = miou_from_histograms(
            inter.cpu(), union.cpu(), target.cpu())
        result = {"mIoU": float(miou) * 100, "mAcc": float(macc) * 100,
                  "aAcc": float(aacc) * 100,
                  "iou_class": [float(x) * 100 for x in iou_c]}
        if cfg.MODEL.NUM_CLASSES == 16:
            result["mIoU*"] = float(miou_star(iou_c)) * 100
        names = (TRAINID2NAME_16 if cfg.MODEL.NUM_CLASSES == 16
                 else TRAINID2NAME_19)
        for idx, iou in enumerate(result["iou_class"]):
            print(f"{names[idx]:>12s}: {iou:6.2f}")
        print(" & ".join(f"{x:.1f}" for x in result["iou_class"])
              + f" & {result['mIoU']:.1f}")
        print(f"mIoU: {result['mIoU']:.2f}", flush=True)
        return result

    def _test_rich(self, max_batches: Optional[int] = None):
        """The rich eval over the test set, ``TEST.BATCH_SIZE`` images a
        batch: saves each batch's artifacts (named after its first image)
        and plots 20 fixed pseudo-random batch indices' first image."""
        cfg = self.cfg
        rich_step = make_rich_eval_step(cfg, self.model)
        viz_list = set(np.random.RandomState(
            max(cfg.SEED, 0) + 1).randint(0, 500, 20).tolist())
        sums = (None, None, None)
        self.model.eval()
        try:
            for i, batch in enumerate(build_test_loader(cfg)):
                if max_batches is not None and i >= max_batches:
                    break
                img, label = self._eval_batch(batch)
                r = rich_step(img, label, flip=True)
                name = (batch["name"][0].rsplit("/", 1)[-1]
                        .rsplit("_", 1)[0] if batch.get("name") else str(i))
                if cfg.TEST.SAVE_EMBED:
                    self._save_artifacts(r, label, name)
                if cfg.TEST.VIZ_WRONG and i in viz_list:
                    self._viz_wrong(r, batch["img"], label, name)
                sums = _accumulate(sums, (r["inter"], r["union"],
                                          r["target"]))
        finally:
            self.model.train()
        return sums

    def _save_artifacts(self, r, label, name):
        """``SAVE_DIR/embed/<name>.pt``: ``torch.save`` of the CPU tensors
        'label' (n, H, W) int32, 'pred' (n, H, W) int32, 'output'
        (n, H, W, K) float32 probabilities and 'embed' (n, h, w, E) float32,
        channel-last, as the JAX package writes them ('embed' only from a
        head that returns an aux map)."""
        embed_dir = os.path.join(self.cfg.SAVE_DIR, "embed")
        os.makedirs(embed_dir, exist_ok=True)
        blob = {"label": label.to(torch.int32), "pred": r["pred"].to(
            torch.int32), "output": r["prob"]}
        if "embed" in r:
            blob["embed"] = r["embed"]
        torch.save({k: v.detach().cpu().contiguous()
                    for k, v in blob.items()},
                   os.path.join(embed_dir, name + ".pt"))

    def _viz_wrong(self, r, img, label, name):
        """The wrong-prediction panels of the batch's first image."""
        from ..ops.resize import resize_bilinear
        from ..utils.visualize import denormalize_image, visualize_wrong
        size = tuple(label.shape[1:3])
        img_native = resize_bilinear(
            torch.from_numpy(np.asarray(img[0], np.float32)), size).numpy()
        mean = np.asarray(self.cfg.INPUT.PIXEL_MEAN) * 255.0
        std = np.asarray(self.cfg.INPUT.PIXEL_STD) * 255.0
        entropy = r["entropy"][0].cpu().numpy()
        radius = (r["radius"][0].cpu().numpy() if "radius" in r
                  else np.zeros_like(entropy))
        visualize_wrong(
            denormalize_image(img_native, mean, std),
            r["pred"][0].cpu().numpy(), label[0].cpu().numpy(), entropy,
            radius, entropy * radius,
            os.path.join(self.cfg.SAVE_DIR, "viz", "wrong", name + ".png"),
            ignore_label=self.cfg.INPUT.IGNORE_LABEL)


def _accumulate(sums, triple):
    """Add an (inter, union, target) triple to running sums (None: none
    yet)."""
    if sums[0] is None:
        return tuple(triple)
    return tuple(a + b for a, b in zip(sums, triple))


PROTOCOLS = {
    "source": SourceLearner,
    "source_free": SourceFreeLearner,
    "source_target": SourceTargetLearner,
    "fully_sup": FullySupervisedLearner,
    "test": TestLearner,
}


def build_learner(cfg, device=None) -> Learner:
    """The learner of ``cfg.PROTOCOL`` on ``device`` (CUDA unless the
    caller passes another)."""
    if cfg.PROTOCOL not in PROTOCOLS:
        raise NotImplementedError(f"Unknown protocol: {cfg.PROTOCOL}")
    return PROTOCOLS[cfg.PROTOCOL](cfg, device=device)
