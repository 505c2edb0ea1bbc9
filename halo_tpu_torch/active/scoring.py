"""Region acquisition scoring (impurity x uncertainty) on torch tensors.

Port of ``halo_tpu/active/scoring.py:78-465``. Region score = purity x
uncertainty over (2r+1)^2 windows, both factors box-filtered maps. Public
functions keep the JAX package's channel-last layout: maps are (H, W) and
per-pixel tensors (H, W, C).

On a CUDA tensor the 'radius'/'hyper' purity map comes from kernel B
(``cuda_radius.radius_map``); on a CPU tensor from its plain version.
"""

from __future__ import annotations

import math
import numpy as np
import torch
import torch.distributed as dist

from ..ops.resize import _contract_w, _interp_matrix, device_matrix
from . import cuda_radius

# The reference normalizes entropy by log(19) even for 16-class SYNTHIA.
_LOG19 = math.log(19.0)

# The one-pass entropy clamps logits to +-60 so exp() needs no max shift.
_ENTROPY_CLAMP = 60.0


def box_filter(x, size: int):
    """(size x size) sliding-window sum over the first two axes with zero
    padding, separable, as explicit shifted adds in the JAX package's
    order. (The JAX package switches to ``lax.reduce_window`` above size
    9; sums there may differ in the last bit.)"""
    if size % 2 != 1:
        raise ValueError(f"box_filter: window size {size} is not odd")
    r = size // 2
    out = x
    for d in (0, 1):
        n = out.shape[d]
        zeros = torch.zeros_like(out.narrow(d, 0, 1)).expand(
            *[r if i == d else -1 for i in range(out.dim())])
        xp = torch.cat([zeros, out, zeros], dim=d)
        acc = xp.narrow(d, 0, n)
        for k in range(1, size):
            acc = acc + xp.narrow(d, k, n)
        out = acc
    return out


def _min_max(x):
    return torch.min(x), torch.max(x)


def normalize_map(x, min_max=_min_max):
    """Global min-max normalization; ``min_max(x) -> (lo, hi)`` gives the
    extremes (of the whole map when ``x`` is a shard of it)."""
    lo, hi = min_max(x)
    return (x - lo) / (hi - lo)


def pixel_entropy(p):
    """Per-pixel predictive entropy / log(19). p: (H, W, C) softmax."""
    return torch.sum(-p * torch.log(p + 1e-6), dim=-1) / _LOG19


def entropy_from_logits(x, precise: bool = False):
    """Predictive-entropy map from (H, W, C) logits.

    precise=True: softmax then -p log(p + 1e-6). precise=False: the
    shift-free identity H = log(s) - t/s with s = sum e^x, t = sum x e^x,
    on logits clamped to +-60.
    """
    if precise:
        return pixel_entropy(torch.softmax(x, dim=-1))
    x = torch.clamp(x, -_ENTROPY_CLAMP, _ENTROPY_CLAMP)
    e = torch.exp(x)
    s = torch.sum(e, dim=-1)
    t = torch.sum(x * e, dim=-1)
    return (torch.log(s) - t / s) / _LOG19


def region_impurity(predict, num_classes: int, size: int, box=box_filter):
    """Per-window class-histogram entropy / log(K) and window pixel count.
    predict: (H, W) int class map. Returns (impurity, count), each (H, W).
    ``box`` is the window sum (``box_filter``, or a sharded one).
    """
    one_hot = torch.nn.functional.one_hot(
        predict.long(), num_classes).to(torch.float32)
    summary = box(one_hot, size)                               # (H, W, K)
    count = torch.sum(summary, dim=-1, keepdim=True)
    freq = summary / count
    imp = torch.sum(-freq * torch.log(freq + 1e-6), dim=-1) / math.log(
        num_classes)
    return imp, count[..., 0]


def _quantize_from_radius(radius, K: int, min_max=_min_max):
    """Quantize an (H, W) radius map into K inverted-normalized bins."""
    eps = 1e-5
    radius = normalize_map(radius, min_max)
    inv = normalize_map(1.0 - radius, min_max)
    q = torch.clamp(inv * K - 0.5, -0.5 + eps, K - 0.5 - eps)
    return torch.round(q).to(torch.int32)


def _radius_map(embed, c: float):
    """Per-pixel Poincare radius of an (H, W, C) embedding: kernel B on a
    CUDA tensor, its plain version (dist0) on a CPU tensor."""
    return cuda_radius.radius_map(embed, c=c)


def _pixel_maps(x, embed, ground_truth, *, unc_type: str, pur_type: str,
                c: float):
    """Per-pixel (H, W) float32 maps the windowed tail consumes — the only
    stage that reads the (H, W, C) tensors."""
    x32 = x.float()
    pix = {}
    if unc_type in ("entropy", "pixel_entropy"):
        pix["pixel_entropy"] = entropy_from_logits(x32)
    elif unc_type == "oracle_acc":
        p = torch.softmax(x32, dim=-1)
        pred = torch.argmax(x32, dim=-1)
        gt = torch.where(ground_truth == 255, pred, ground_truth.long())
        pix["one_minus_p_true"] = 1.0 - torch.gather(
            p, -1, gt[..., None])[..., 0]

    if pur_type == "ripu":
        pix["predict"] = torch.argmax(x32, dim=-1)
    elif pur_type == "oracle_ripu":
        pix["predict"] = torch.where(ground_truth == 255,
                                     torch.argmax(x32, dim=-1),
                                     ground_truth.long())
    elif pur_type in ("hyper", "radius"):
        pix["radius"] = _radius_map(embed, c)
    elif pur_type == "euc_norm":
        e32 = embed.float()
        pix["euc_norm"] = torch.sqrt(torch.sum(e32 * e32, dim=-1))
    return pix


def _score_tail(pix, shape, device, *, unc_type: str, pur_type: str,
                size: int, num_classes: int, K: int, normalize: bool,
                box=box_filter, min_max=_min_max):
    """Windowed uncertainty/impurity + normalize + combine from per-pixel
    maps; shared by the scorers. ``box`` and ``min_max`` are the window
    sum and the extremes (of the whole map, for a shard of it)."""
    if unc_type == "pixel_entropy":
        unc = pix["pixel_entropy"]
    elif unc_type == "entropy":
        unc = box(pix["pixel_entropy"], size)
    elif unc_type == "oracle_acc":
        unc = box(pix["one_minus_p_true"], size)
    else:
        # 'none' and the reference's dead 'hyperbolic'/'certainty' options
        unc = torch.zeros(shape, dtype=torch.float32, device=device)

    if pur_type in ("ripu", "oracle_ripu"):
        imp, count = region_impurity(pix["predict"], num_classes, size, box)
    elif pur_type == "hyper":
        imp, count = region_impurity(
            _quantize_from_radius(pix["radius"], K, min_max), K, 3, box)
    elif pur_type == "radius":
        imp, count = pix["radius"], None
    elif pur_type == "euc_norm":
        imp, count = pix["euc_norm"], None
    elif pur_type == "none":
        imp = torch.zeros(shape, dtype=torch.float32, device=device)
        count = None
    else:
        raise NotImplementedError(
            f"Error: purity type '{pur_type}' not implemented")

    if count is not None:
        unc = unc / count
    if normalize:
        unc = normalize_map(unc, min_max)
        imp = normalize_map(imp, min_max)
    return imp * unc, imp, unc


def floating_region_score(logits, embed=None, ground_truth=None, *,
                          unc_type: str = "entropy", pur_type: str = "radius",
                          size: int = 3, num_classes: int = 19, K: int = 100,
                          normalize: bool = True, c: float = 1.0):
    """Full region score for one image from native-resolution maps:
    logits (H, W, num_classes), embed (H, W, C), ground_truth (H, W).
    Returns (score, impurity, uncertainty), each (H, W) float32."""
    pix = _pixel_maps(logits, embed, ground_truth, unc_type=unc_type,
                      pur_type=pur_type, c=c)
    return _score_tail(pix, tuple(logits.shape[:2]), logits.device,
                       unc_type=unc_type, pur_type=pur_type, size=size,
                       num_classes=num_classes, K=K, normalize=normalize)


def fused_upsample_region_score(logits_in, embed_in=None, native_hw=None,
                                ground_truth=None, *,
                                score_dtype=torch.bfloat16,
                                block_rows: int = 128,
                                unc_type: str = "entropy",
                                pur_type: str = "radius", size: int = 3,
                                num_classes: int = 19, K: int = 100,
                                normalize: bool = True, c: float = 1.0):
    """floating_region_score with the native-resolution upsample folded in.

    A plain loop over ``block_rows``-row blocks of the native map: each
    block is interpolated with the same banded align-corners contractions
    as ``resize_bilinear`` (row matrix sliced to the block), cast
    f32 -> ``score_dtype`` like the materializing path, and reduced to the
    per-pixel maps at once, so the native (H, W, C) logits and embedding
    never exist whole.

    logits_in: (h, w, C) model-output logits; embed_in: (h2, w2, E)
    feature-resolution embedding or None; native_hw: (H, W);
    ground_truth: (H, W) labels at native resolution (oracle_* types).
    """
    H, W = int(native_hw[0]), int(native_hw[1])
    blk = min(block_rows, H)

    def interp_rows(src, r0):
        in_h, in_w = src.shape[0], src.shape[1]
        if (in_h, in_w) == (H, W):
            return src[r0:r0 + blk]
        m = _interp_matrix(H, in_h)[r0:r0 + blk]
        nz = np.nonzero(m.any(axis=0))[0]
        i0, i1 = int(nz[0]), int(nz[-1]) + 1   # contiguous input band
        rows = device_matrix(H, in_h, (r0, r0 + m.shape[0]), (i0, i1),
                             src.device, torch.float32)
        y = torch.einsum("oh,hwc->owc", rows, src[i0:i1])
        return _contract_w(y, W, in_w, torch.float32)

    lg32 = logits_in.float()
    needs_embed = pur_type in ("hyper", "radius", "euc_norm")
    em32 = (embed_in.float()
            if (embed_in is not None and needs_embed) else None)

    blocks = []
    for r0 in range(0, H, blk):
        lg = interp_rows(lg32, r0).to(score_dtype)
        em = (interp_rows(em32, r0).to(score_dtype).contiguous()
              if em32 is not None else None)
        gt = (ground_truth[r0:r0 + blk]
              if ground_truth is not None else None)
        blocks.append(_pixel_maps(lg, em, gt, unc_type=unc_type,
                                  pur_type=pur_type, c=c))
    pix = {k: torch.cat([b[k] for b in blocks], dim=0) for k in blocks[0]}
    return _score_tail(pix, (H, W), logits_in.device, unc_type=unc_type,
                       pur_type=pur_type, size=size, num_classes=num_classes,
                       K=K, normalize=normalize)


def _sharded_box(group, rank: int, n: int):
    """``box_filter`` over a shard of the map's rows: r = size // 2 rows
    from each neighbour (zeros beyond the map's top and bottom, as the
    unsharded filter pads) are put around the shard, filtered, and cut
    off again. The halos travel in one all-reduce (SUM) of a zeroed
    (n, 2, r, W, ...) buffer into which each rank writes its first and
    last r rows: exact, since x + 0 = x."""

    def box(x, size):
        r = size // 2
        if r == 0:
            return box_filter(x, size)
        if x.shape[0] < r:
            raise ValueError(f"a shard of {x.shape[0]} rows is thinner "
                             f"than the window's halo of {r}")
        buf = x.new_zeros((n, 2, r) + tuple(x.shape[1:]))
        buf[rank, 0] = x[:r]
        buf[rank, 1] = x[-r:]
        dist.all_reduce(buf, group=group)
        above = buf[rank - 1, 1] if rank > 0 else torch.zeros_like(x[:r])
        below = (buf[rank + 1, 0] if rank < n - 1
                 else torch.zeros_like(x[:r]))
        ext = torch.cat([above, x, below], dim=0)
        return box_filter(ext, size)[r:r + x.shape[0]]

    return box


def _global_min_max(group):
    """The extremes of the whole map from each rank's shard: one
    all-reduce (MAX) of (max, -min)."""

    def min_max(x):
        ext = torch.stack([torch.max(x), -torch.min(x)]).float()
        dist.all_reduce(ext, op=dist.ReduceOp.MAX, group=group)
        return (-ext[1]).to(x.dtype), ext[0].to(x.dtype)

    return min_max


def spatial_region_score(logits, embed=None, ground_truth=None, *, group,
                         unc_type: str = "entropy", pur_type: str = "radius",
                         size: int = 3, num_classes: int = 19, K: int = 100,
                         normalize: bool = True, c: float = 1.0):
    """``floating_region_score`` with the map's H axis sharded over the
    ranks of ``group`` (port of the JAX package's
    ``spatial_region_score``, whose H is sharded over the mesh's ``model``
    axis): each rank passes its contiguous H/n rows of logits (h, W, K),
    embedding (h, W, C) and ground truth (h, W) and receives its rows of
    (score, impurity, uncertainty). The per-pixel maps are the rank's own
    (kernel B on its rows on a CUDA tensor); the (2r+1)^2 window sums
    take r halo rows from each neighbour, the map's top and bottom rows
    see the zero padding of the unsharded map, and the min-max
    normalisations read the whole map's extremes. The sums see the same
    operands in the same order, so the rows equal the unsharded ones.
    Raises ValueError when H is not divisible by the group's size (the
    ranks' row counts differ). Every collective is an all-reduce on the
    logits' device."""
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    rows = torch.tensor([logits.shape[0], -logits.shape[0]],
                        dtype=torch.float32, device=logits.device)
    dist.all_reduce(rows, op=dist.ReduceOp.MAX, group=group)
    if int(rows[0]) != -int(rows[1]):
        raise ValueError(
            f"spatial_region_score: the ranks hold {-int(rows[1])} to "
            f"{int(rows[0])} rows: H is not divisible by the group's size "
            f"{n}")
    pix = _pixel_maps(logits, embed, ground_truth, unc_type=unc_type,
                      pur_type=pur_type, c=c)
    return _score_tail(pix, tuple(logits.shape[:2]), logits.device,
                       unc_type=unc_type, pur_type=pur_type, size=size,
                       num_classes=num_classes, K=K, normalize=normalize,
                       box=_sharded_box(group, rank, n),
                       min_max=_global_min_max(group))
