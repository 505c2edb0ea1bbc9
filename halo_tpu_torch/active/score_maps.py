"""The maps a region score is made of, below the scorers that combine them:
the entropy of logits, the window sum and the min-max normalisation.
``scoring`` (the scorers) and ``cuda_score`` (the score kernel pair's plain
version) both build on them."""

from __future__ import annotations

import math

import torch

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
