"""JAX parameter trees -> the port's ``state_dict``.

``variables_to_state_dict`` is the inverse of the name maps of
``halo_tpu/models/port_torch.py``: it turns the JAX package's
``{'params', 'frozen', 'batch_stats'}`` tree (numpy arrays) into a
``state_dict`` for ``Segmentor``, whose names are the upstream torch
checkpoint names:

  flax conv kernel (kh, kw, I, O)  -> torch weight (O, I, kh, kw)
  flax depthwise (kh, kw, 1, C)    -> torch weight (C, 1, kh, kw)
  flax Dense kernel (I, O)         -> torch weight (O, I)
  frozen BN buffers                -> FrozenBatchNorm2d buffers
  live BN scale/bias + mean/var    -> weight/bias + running_mean/var
  hfr/bn                           -> wn_mlp.1
  mlr/p_mlr, mlr/a_mlr             -> conv_seg.P_MLR, conv_seg.A_MLR
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

# JAX norm-module names; a live BN nests its flax BatchNorm under a 'bn'
# child of these.
_NORM_SCOPES = {"bn1", "bn2", "bn3", "downsample_bn", "norm"}
_SEQ_CHILD = {"conv": 0, "norm": 1}       # ConvBNReLU children
_SEP_CHILD = {("depthwise", "conv"): "depthwise_conv",
              ("depthwise", "norm"): "depthwise_bn",
              ("pointwise", "conv"): "pointwise_conv",
              ("pointwise", "norm"): "pointwise_bn"}
_BN_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var", "weight": "weight",
            "running_mean": "running_mean", "running_var": "running_var"}


def _backbone_name(path: Tuple[str, ...]) -> str:
    head, rest = path[0], path[1:]
    if head.startswith("layer"):
        stage, block = head[len("layer"):].split("_")
        mod = {"downsample_conv": "downsample.0",
               "downsample_bn": "downsample.1"}.get(rest[0], rest[0])
        return f"backbone.layer{stage}.{block}.{mod}"
    return f"backbone.{head}"


def _head_name(path: Tuple[str, ...]) -> str:
    if path[0] == "aspp":
        blk, rest = path[1], path[2:]
        if blk == "global_branch":  # AdaptiveAvgPool2d sits at index 0
            return f"global_branch.{_SEQ_CHILD[rest[0]] + 1}"
        if blk in ("bottleneck", "shortcut"):
            return f"{blk}.{_SEQ_CHILD[rest[0]]}"
        kind, idx = blk.rsplit("_", 1)
        prefix = {"branch": "parallel_branches", "decoder": "decoder"}[kind]
        if len(rest) == 1:
            return f"{prefix}.{idx}.{_SEQ_CHILD[rest[0]]}"
        return f"{prefix}.{idx}.{_SEP_CHILD[tuple(rest)]}"
    if path[0] == "hfr":
        return "wn_mlp." + {"fc1": "0", "bn": "1", "fc2": "3"}[path[1]]
    if path[0] == "mlr":
        return "conv_seg"
    return path[0]  # conv_reduce


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def variables_to_state_dict(variables: Dict) -> Dict[str, torch.Tensor]:
    """Convert a JAX ``Segmentor`` variable tree into the port's
    ``state_dict`` (float32 tensors, plus ``num_batches_tracked`` = 0 for
    every live BatchNorm so ``load_state_dict(strict=True)`` holds)."""
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "frozen", "batch_stats"):
        for full, value in _leaves(variables.get(collection, {})):
            module, path, leaf = full[0], full[1:-1], full[-1]
            live_bn = collection == "batch_stats" or leaf == "scale"
            if (len(path) >= 2 and path[-1] == "bn"
                    and path[-2] in _NORM_SCOPES):
                path = path[:-1]
            name = (_backbone_name(path) if module == "feature_extractor"
                    else _head_name(path))
            if leaf == "kernel":
                value = (value.transpose(3, 2, 0, 1) if value.ndim == 4
                         else value.T)
                leaf = "weight"
            elif leaf in ("p_mlr", "a_mlr"):
                leaf = leaf[0].upper() + "_MLR"
            elif leaf in _BN_LEAF:
                leaf = _BN_LEAF[leaf]
            key = f"{module}.{name}.{leaf}"
            out[key] = torch.from_numpy(np.array(value, dtype=np.float32))
            if live_bn:
                out[f"{module}.{name}.num_batches_tracked"] = torch.tensor(0)
    return out
