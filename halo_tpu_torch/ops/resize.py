"""Bilinear resize with align_corners=True, as two banded contractions, and
nearest-neighbour resize.

Port of ``halo_tpu/ops/resize.py``: the resize is ``M_h @ X @ M_w^T`` with
the exact align-corners interpolation matrices. Large outputs contract
block-wise against each block's contiguous input band (2 taps per output
row), so every output sums the same two taps as the JAX package. Tensors
are channel-last: (..., H, W, C).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=64)
def _interp_matrix(out_size: int, in_size: int) -> np.ndarray:
    """Dense (out, in) align-corners linear interpolation matrix."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == 1 or out_size == 1:
        m[:, 0] = 1.0
        return m
    scale = (in_size - 1) / (out_size - 1)
    src = np.arange(out_size, dtype=np.float64) * scale
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    w = (src - lo).astype(np.float32)
    rows = np.arange(out_size)
    np.add.at(m, (rows, lo), 1.0 - w)
    np.add.at(m, (rows, hi), w)
    return m


_BAND_BLOCK = 128  # output rows per banded block


@lru_cache(maxsize=64)
def _band_ranges(out_size: int, in_size: int):
    """(out_lo, out_hi, in_lo, in_hi) partition of the banded matrix: each
    _BAND_BLOCK-row output block touches one contiguous input band."""
    m = _interp_matrix(out_size, in_size)
    ranges = []
    for o0 in range(0, out_size, _BAND_BLOCK):
        o1 = min(o0 + _BAND_BLOCK, out_size)
        nz = np.nonzero(m[o0:o1].any(axis=0))[0]
        ranges.append((o0, o1, int(nz[0]), int(nz[-1]) + 1))
    return tuple(ranges)


@lru_cache(maxsize=1024)
def device_matrix(out_size: int, in_size: int, rows: tuple, cols: tuple,
                  device: torch.device, dtype) -> torch.Tensor:
    """Slice [rows, cols] of the interpolation matrix as a tensor on
    ``device``, uploaded once per slice and reused."""
    m = _interp_matrix(out_size, in_size)[rows[0]:rows[1], cols[0]:cols[1]]
    return torch.from_numpy(np.ascontiguousarray(m)).to(device, dtype)


def _full(out_size, in_size):
    return (0, out_size), (0, in_size)


def _contract_h(y, out_size, in_size, dtype):
    if out_size < 2 * _BAND_BLOCK:
        m = device_matrix(out_size, in_size, *_full(out_size, in_size),
                          y.device, dtype)
        return torch.einsum("oh,...hwc->...owc", m, y)
    return torch.cat([
        torch.einsum("oh,...hwc->...owc",
                     device_matrix(out_size, in_size, (o0, o1), (i0, i1),
                                   y.device, dtype),
                     y[..., i0:i1, :, :])
        for o0, o1, i0, i1 in _band_ranges(out_size, in_size)], dim=-3)


def _contract_w(y, out_size, in_size, dtype):
    if out_size < 2 * _BAND_BLOCK:
        m = device_matrix(out_size, in_size, *_full(out_size, in_size),
                          y.device, dtype)
        return torch.einsum("pw,...hwc->...hpc", m, y)
    return torch.cat([
        torch.einsum("pw,...hwc->...hpc",
                     device_matrix(out_size, in_size, (o0, o1), (i0, i1),
                                   y.device, dtype),
                     y[..., :, i0:i1, :])
        for o0, o1, i0, i1 in _band_ranges(out_size, in_size)], dim=-2)


def resize_bilinear(x, out_hw, dtype=None):
    """Resize (..., H, W, C) tensors to ``out_hw`` with align_corners=True.

    dtype: accumulation dtype; defaults to x.dtype (float32 for integer
    inputs). With dtype given, the result stays in it.
    """
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    in_h, in_w = x.shape[-3], x.shape[-2]
    if (in_h, in_w) == (out_h, out_w):
        return x
    cdtype = dtype or (x.dtype if x.is_floating_point() else torch.float32)
    y = x.to(cdtype)
    y = _contract_h(y, out_h, in_h, cdtype)
    y = _contract_w(y, out_w, in_w, cdtype)
    return y.to(x.dtype) if dtype is None else y


def resize_nearest(x, out_hw):
    """Nearest-neighbour resize of (..., H, W, C) tensors (labels, masks)
    with cv2.INTER_NEAREST's source index floor(i * in / out)."""
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    in_h, in_w = x.shape[-3], x.shape[-2]
    if (in_h, in_w) == (out_h, out_w):
        return x
    rows = np.minimum((np.arange(out_h) * in_h / out_h).astype(np.int64),
                      in_h - 1)
    cols = np.minimum((np.arange(out_w) * in_w / out_w).astype(np.int64),
                      in_w - 1)
    rows = torch.from_numpy(rows).to(x.device)
    cols = torch.from_numpy(cols).to(x.device)
    return x.index_select(-3, rows).index_select(-2, cols)
