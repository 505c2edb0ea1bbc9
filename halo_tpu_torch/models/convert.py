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
  aspp_<i> (DeepLab-v2 ASPP)       -> conv2d_list.<i>
  cls_conv (Euclidean v3+)         -> decoder.3 in the upstream
                                      ``old_decoder`` layout (no
                                      conv_reduce, no HFR), else cls_conv

Grouped (ResNeXt) kernels (kh, kw, I/g, O) carry over like dense ones.
A MiT trunk (``segformer.py``) takes the upstream NVlabs names, the
inverse of ``_mit_torch_to_flax`` in ``port_torch.py``:

  patch_embed<s>/{proj,norm}       -> backbone.patch_embed<s>.{proj,norm}
  block<s>_<i>/{norm1,norm2}       -> backbone.block<s>.<i>.{norm1,norm2}
  block<s>_<i>/attn/{q,sr,proj}    -> ....attn.{q,sr,proj}
  block<s>_<i>/attn/sr_norm        -> ....attn.norm
  block<s>_<i>/attn/k + attn/v     -> ....attn.kv (k's rows, then v's)
  block<s>_<i>/ffn/{fc1,fc2}       -> ....mlp.{fc1,fc2}
  block<s>_<i>/ffn/dwconv          -> ....mlp.dwconv.dwconv
  norm<s>                          -> backbone.norm<s>
  LayerNorm scale                  -> weight

The SegFormer heads keep the JAX names (``linear_c<s>``, ``fuse_conv``,
``fuse_bn``, ``cls``, ``conv_reduce``); ``fuse_bn`` is a live BN.
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


# MiT block parts whose upstream names differ from the JAX path
_MIT_PARTS = {("attn", "sr_norm"): "attn.norm",
              ("attn", "k"): "attn.kv", ("attn", "v"): "attn.kv",
              ("ffn", "fc1"): "mlp.fc1", ("ffn", "fc2"): "mlp.fc2",
              ("ffn", "dwconv"): "mlp.dwconv.dwconv"}


def _mit_name(path: Tuple[str, ...]) -> str:
    head, rest = path[0], path[1:]
    if head.startswith("block"):
        stage, block = head[len("block"):].split("_")
        part = _MIT_PARTS.get(tuple(rest), ".".join(rest))
        return f"backbone.block{stage}.{block}.{part}"
    return "backbone." + ".".join(path)


def _head_name(path: Tuple[str, ...], old_decoder: bool) -> str:
    if path[0].startswith("aspp_"):
        return f"conv2d_list.{path[0].split('_')[1]}"
    if path[0] == "cls_conv":
        return "decoder.3" if old_decoder else "cls_conv"
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
    params = variables.get("params", {})
    head = params.get("classifier", {})
    old_decoder = "cls_conv" in head and not {"conv_reduce", "hfr"} & set(
        head)
    mit = "patch_embed1" in params.get("feature_extractor", {})
    kv: Dict[str, Dict[str, np.ndarray]] = {}
    for collection in ("params", "frozen", "batch_stats"):
        for full, value in _leaves(variables.get(collection, {})):
            module, path, leaf = full[0], full[1:-1], full[-1]
            trunk = module == "feature_extractor"
            # a MiT trunk's only norms are LayerNorms
            live_bn = collection == "batch_stats" or (
                leaf == "scale" and not (trunk and mit))
            if (len(path) >= 2 and path[-1] == "bn"
                    and path[-2] in _NORM_SCOPES):
                path = path[:-1]
            if trunk:
                name = _mit_name(path) if mit else _backbone_name(path)
            else:
                name = _head_name(path, old_decoder)
            if leaf == "kernel":
                value = (value.transpose(3, 2, 0, 1) if value.ndim == 4
                         else value.T)
                leaf = "weight"
            elif leaf in ("p_mlr", "a_mlr"):
                leaf = leaf[0].upper() + "_MLR"
            elif leaf in _BN_LEAF:
                leaf = _BN_LEAF[leaf]
            key = f"{module}.{name}.{leaf}"
            value = np.array(value, dtype=np.float32)
            if name.endswith("attn.kv"):
                kv.setdefault(key, {})[path[-1]] = value
                continue
            out[key] = torch.from_numpy(value)
            if live_bn:
                out[f"{module}.{name}.num_batches_tracked"] = torch.tensor(0)
    for key, parts in kv.items():
        out[key] = torch.from_numpy(np.concatenate([parts["k"], parts["v"]]))
    return out
