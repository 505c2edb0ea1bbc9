"""Pretrained trunk weights (``MODEL.WEIGHTS``).

Counterpart of ``resolve_pretrained_weights``, ``load_torch_checkpoint``
and ``load_pretrained_backbone`` in ``halo_tpu/models/port_torch.py``. The
file is a torchvision ResNet/ResNeXt ``state_dict`` (``conv1.weight``,
``layer3.7.conv2.weight``, ...) or an NVlabs MiT one
(``patch_embed1.proj.weight``, ``block3.5.attn.kv.weight``, ...),
optionally under a ``state_dict`` key and a ``backbone.`` or
``feature_extractor.backbone.`` prefix. The trunk's names are the
upstream ones, so the tensors land by name. The ImageNet classifier
(``fc.*`` of a ResNet, ``head.*`` of a MiT) has no destination in the
trunk and is dropped, as are BatchNorm ``num_batches_tracked`` counters.
Every other tensor must land on the trunk, and the trunk must get every
tensor it has: nothing is downloaded, and nothing falls back to the
random init.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

_DROPPED = ("fc.", "head.")
_PREFIXES = ("feature_extractor.backbone.", "backbone.")


def resolve_pretrained_weights(spec: str) -> Optional[str]:
    """``MODEL.WEIGHTS`` as a local file: ``''`` -> None (skip); a path ->
    itself (FileNotFoundError if absent); a URL -> its basename in the
    torch hub cache (``$TORCH_HOME/hub/checkpoints`` or
    ``$TORCH_HOME/checkpoints``, ``TORCH_HOME`` defaulting to
    ``~/.cache/torch``), RuntimeError when it is not cached."""
    spec = str(spec or "")
    if not spec:
        return None
    if "://" not in spec:
        if not os.path.exists(spec):
            raise FileNotFoundError(
                f"MODEL.WEIGHTS points at a missing file: {spec}")
        return spec
    name = spec.rsplit("/", 1)[-1]
    torch_home = os.environ.get(
        "TORCH_HOME", os.path.join(os.path.expanduser("~"), ".cache",
                                   "torch"))
    candidates = [os.path.join(torch_home, "hub", "checkpoints", name),
                  os.path.join(torch_home, "checkpoints", name)]
    for path in candidates:
        if os.path.exists(path):
            return path
    raise RuntimeError(
        f"MODEL.WEIGHTS is a URL ({spec}) but {name} is not in the torch "
        f"hub cache ({candidates[0]}). Copy the file there on a host with "
        "network access, or set MODEL.WEIGHTS to a local path, or to '' "
        "to start from the seeded random init.")


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a torch ``.pth``/``.ckpt`` (plain ``state_dict`` or
    one under ``state_dict``), on the CPU."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(blob, dict) and "state_dict" in blob:
        blob = blob["state_dict"]
    return {k: v for k, v in blob.items() if isinstance(v, torch.Tensor)}


def load_pretrained_backbone(model, spec: str) -> Optional[str]:
    """Load the trunk ``model.feature_extractor.backbone`` from
    ``MODEL.WEIGHTS`` strictly; returns the file read (None when ``spec``
    is empty). Raises when a tensor has no destination, when the file
    lacks one of the trunk's tensors or holds one of another shape, and
    when nothing in the file matches."""
    path = resolve_pretrained_weights(spec)
    if path is None:
        return None
    backbone = model.feature_extractor.backbone
    found = {}
    for key, value in load_torch_checkpoint(path).items():
        for prefix in _PREFIXES:
            if key.startswith(prefix):
                key = key[len(prefix):]
                break
        if key.startswith(_DROPPED) or key.endswith("num_batches_tracked"):
            continue
        found[key] = value
    own = {k: v for k, v in backbone.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    if not found.keys() & own.keys():
        raise RuntimeError(
            f"{path}: no tensor matches the trunk — not a torchvision "
            "ResNet/ResNeXt or NVlabs MiT state_dict. Refusing to continue "
            "from the random init.")
    unexpected = sorted(found.keys() - own.keys())
    missing = sorted(own.keys() - found.keys())
    if unexpected or missing:
        raise RuntimeError(
            f"{path} does not fit the trunk (wrong MODEL.NAME for these "
            f"weights?): {len(unexpected)} tensors without a destination "
            f"{unexpected[:8]}, {len(missing)} of the trunk's missing "
            f"{missing[:8]}")
    for key, value in found.items():
        if tuple(value.shape) != tuple(own[key].shape):
            raise RuntimeError(f"{path}: {key} has shape "
                               f"{tuple(value.shape)}, the trunk "
                               f"{tuple(own[key].shape)}")
    with torch.no_grad():
        for key, target in own.items():
            target.copy_(found[key])
    print(f"loaded {len(found)} tensors into feature_extractor from {path}",
          flush=True)
    return path
