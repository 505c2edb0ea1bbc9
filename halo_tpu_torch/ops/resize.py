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


@lru_cache(maxsize=64)
def interp_table(out_size: int, in_size: int) -> np.ndarray:
    """(4, out) int32 table of ``_interp_matrix``'s rows: the first and last
    column of each row's nonzero entries (lo, hi; hi = lo where the row has
    one), then those two entries' float32 bits (w_lo, w_hi = 0 where hi =
    lo). ``w_lo * x[lo] + w_hi * x[hi]`` is the row's dot product with its
    zero terms left out; placing w_lo at lo and adding w_hi at hi rebuilds
    the matrix exactly."""
    m = _interp_matrix(out_size, in_size)
    nz = m != 0
    rows = np.arange(out_size)
    lo = nz.argmax(axis=1)
    hi = in_size - 1 - nz[:, ::-1].argmax(axis=1)
    if not (nz.any(axis=1).all() and (hi - lo <= 1).all()):
        raise AssertionError("an interpolation row is not one or two "
                             "neighbouring taps")
    w_lo = m[rows, lo]
    w_hi = np.where(hi != lo, m[rows, hi], np.float32(0))
    return np.stack([lo.astype(np.int32), hi.astype(np.int32),
                     w_lo.astype(np.float32).view(np.int32),
                     w_hi.astype(np.float32).view(np.int32)])


@lru_cache(maxsize=64)
def device_table(out_size: int, in_size: int,
                 device: torch.device) -> torch.Tensor:
    """``interp_table`` on ``device``, uploaded once per size and reused."""
    return torch.from_numpy(interp_table(out_size, in_size)).to(device)


def resize_by_table(x, rows, cols):
    """Align-corners resize of an (h, w, C) float32 map by ``device_table``s
    of its rows and columns: rows first, then columns, each output the sum
    of two products, each product and the sum rounded apart (three eager
    ops), as ``csrc/region_score.cu`` computes it."""
    def taps(t, src, dim):
        lo, hi = t[0].long(), t[1].long()
        shape = [1] * src.dim()
        shape[dim] = -1
        w_lo = t[2].view(torch.float32).reshape(shape)
        w_hi = t[3].view(torch.float32).reshape(shape)
        return (w_lo * src.index_select(dim, lo)
                + w_hi * src.index_select(dim, hi))
    return taps(cols, taps(rows, x, 0), 1)


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
