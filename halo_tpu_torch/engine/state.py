"""Checkpoints of the port (port of ``halo_tpu/engine/state.py:57-153``).

A checkpoint is ``torch.save`` of ``{"state_dict", "optimizer", "step",
"extra"}``: the model's ``state_dict`` under the upstream torch names, the
optimizer's state, the step count and learner counters. The JAX package
reads ``blob["state_dict"]`` of such a file
(``halo_tpu/models/port_torch.py:load_torch_checkpoint``), so a port
checkpoint loads there too. ``restore_state`` brings a whole run back
from one: model, optimizer, the schedule's position and the step.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch


def save_checkpoint(model, path: str, optimizer=None, step: int = 0,
                    extra: Optional[Dict] = None):
    """Write the checkpoint atomically (temporary file, then rename)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    blob = {"state_dict": {k: v.detach().cpu()
                           for k, v in model.state_dict().items()},
            "optimizer": (optimizer.state_dict()
                          if optimizer is not None else {}),
            "step": int(step), "extra": dict(extra or {})}
    tmp = path + ".tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)


def load_checkpoint_blob(path: str) -> Dict:
    """The whole checkpoint, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=False)


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of a checkpoint: a port or upstream Lightning
    file (``blob["state_dict"]``) or a plain ``state_dict``."""
    blob = load_checkpoint_blob(path)
    if isinstance(blob, dict) and "state_dict" in blob:
        blob = blob["state_dict"]
    return blob


def restore_state(model, optimizer, scheduler, path: str) -> Dict:
    """Full-state restore of a port checkpoint: the model's ``state_dict``
    (strict), the optimizer's state (momentum buffers, group LRs) and the
    ``LambdaLR`` at the saved step, so its next ``step()`` gives the LR of
    the step after. Returns the blob (``step``, ``extra``)."""
    blob = load_checkpoint_blob(path)
    model.load_state_dict(blob["state_dict"], strict=True)
    optimizer.load_state_dict(blob["optimizer"])
    step = int(blob["step"])
    scheduler.last_epoch = step
    for group, base, factor in zip(optimizer.param_groups,
                                   scheduler.base_lrs, scheduler.lr_lambdas):
        group["lr"] = base * factor(step)
    scheduler._last_lr = [group["lr"] for group in optimizer.param_groups]
    return blob


def load_module_params(model, path: str, module: str) -> bool:
    """Load one top-level module's parameters and buffers
    (``feature_extractor`` or ``classifier``) from a checkpoint, as the
    reference filters its ``state_dict`` by prefix. Keys under the prefix
    must match the module's exactly; a checkpoint without the module
    leaves it as it is. Returns whether the checkpoint held the module."""
    prefix = module + "."
    found = {k[len(prefix):]: v for k, v in load_state_dict_file(path).items()
             if k.startswith(prefix)}
    if found:
        getattr(model, module).load_state_dict(found, strict=True)
    return bool(found)
