"""Kernel B redesigned as the round's score stage (CUDA): the region score of
one image from the head's outputs, upsample included, in two launches.

``region_score`` is the wrapper: on a CUDA tensor it launches
``csrc/region_score.cu`` (S1, the tile pass: upsample, entropy, radius,
window sum and each tile's extremes; then S2, the normalisation and the
product) or raises; on a CPU tensor it takes the plain version,
``region_score_plain``, the same arithmetic as eager ops.
``region_maps`` is S1 alone: the raw windowed entropy and radius, for a
caller that finishes them itself (``scoring.fused_upsample_region_score``
for purity ``hyper``). Which score types come here is the caller's
choice (``scoring.score_route``). The upsampled values of kernel and
plain version are equal bit for bit (the same tables, products and sums
rounded apart), so the maps differ by the order of the channel sums only.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache

import numpy as np
import torch

from .. import kernels
from ..ops import hyperbolic as hyp
from ..ops.resize import device_table, interp_table, resize_by_table
from .score_maps import box_filter, entropy_from_logits, normalize_map

# Launches of S1 (one a scored image) and of S2 (one a ``region_score``
# call), each counted where it launches and nowhere else.
launches = 0
launches_s2 = 0

# S1's tile of native pixels (rows, columns): csrc/region_score.cu's
# kTH, kTW. Its largest window half-width is kMaxR.
TILE = (16, 64)
MAX_HALO = 8
# Shared memory for a channel chunk's two staging buffers and its row
# contraction (the rest is the haloed tile's entropies): three blocks fit
# on a multiprocessor.
_CHUNK_BYTES = 64 * 1024
# The most dynamic shared memory a block may take (227 KB, less S1's
# static tables).
_SMEM_LIMIT = 227 * 1024 - 1024
_INV_LOG19 = float(np.float32(1.0) / np.float32(math.log(19.0)))


def region_maps_plain(logits, embed, native_hw, *,
                      score_dtype=torch.bfloat16, halo: int = 1,
                      c: float = 1.0):
    """Plain version of S1: (uncertainty, radius), each (H, W) float32,
    of logits (h, w, classes) and a ball embedding (h2, w2, E) at the
    native (H, W): ``resize_by_table`` of both in float32, cast to
    ``score_dtype``, ``entropy_from_logits``, ``dist0``, then the
    (2 halo + 1)^2 ``box_filter`` of the entropy (none for halo 0)."""
    H, W = int(native_hw[0]), int(native_hw[1])
    dev = logits.device

    def up(x):
        return resize_by_table(x.float(), device_table(H, x.shape[0], dev),
                               device_table(W, x.shape[1], dev)
                               ).to(score_dtype)
    entropy = entropy_from_logits(up(logits).float())
    radius = hyp.dist0(up(embed).float(), c=c, dim=-1)
    unc = box_filter(entropy, 2 * halo + 1) if halo else entropy
    return unc, radius


def region_score_plain(logits, embed, native_hw, *,
                       score_dtype=torch.bfloat16, halo: int = 1,
                       c: float = 1.0, normalize: bool = True):
    """Plain version of S1 + S2: (score, impurity, uncertainty), each (H, W)
    float32: ``region_maps_plain``, each map through ``normalize_map``
    when ``normalize``, and their product."""
    unc, imp = region_maps_plain(logits, embed, native_hw,
                                 score_dtype=score_dtype, halo=halo, c=c)
    if normalize:
        unc, imp = normalize_map(unc), normalize_map(imp)
    return imp * unc, imp, unc


@lru_cache(maxsize=64)
def _span(out_size: int, in_size: int, tile: int, halo: int) -> int:
    """The most input rows (or columns) one tile of ``tile`` outputs and
    ``halo`` more on each side reads."""
    t = interp_table(out_size, in_size)
    most = 0
    for x0 in range(0, out_size, tile):
        xl, xr = max(x0 - halo, 0), min(x0 + tile + halo, out_size) - 1
        most = max(most, int(t[1, xr]) - int(t[0, xl]) + 1)
    return most


def _chunk(channels: int, per_channel: int) -> int:
    """Channels a chunk: as many as ``_CHUNK_BYTES`` holds, then evened out
    over the chunks that makes."""
    ck = max(1, min(channels, _CHUNK_BYTES // per_channel))
    n = -(-channels // ck)
    return -(-channels // n)


@lru_cache(maxsize=64)
def plan(H: int, W: int, lg_hw, em_hw, k_cls: int, e_dim: int,
         halo: int) -> tuple:
    """S1's shared-memory plan: (ck_l, ck_e, nbp_l, nbp_e, x_words,
    r_words, smem bytes). A source's band is nr input rows x nbp columns
    (the most any tile reads, padded to an odd stride, free of bank
    conflicts) x ck channels, staged twice (double buffer) and contracted
    over rows into rows x ck x nbp floats."""
    th, tw = TILE
    rows_l = th + 2 * halo
    nr_l, nr_e = _span(H, lg_hw[0], th, halo), _span(H, em_hw[0], th, 0)
    nbp_l, nbp_e = _span(W, lg_hw[1], tw, halo) | 1, \
        _span(W, em_hw[1], tw, 0) | 1
    ck_l = _chunk(k_cls, 4 * nbp_l * (2 * nr_l + rows_l))
    ck_e = _chunk(e_dim, 4 * nbp_e * (2 * nr_e + th))
    x_words = max(nr_l * ck_l * nbp_l, nr_e * ck_e * nbp_e)
    r_words = max(rows_l * ck_l * nbp_l, th * ck_e * nbp_e)
    smem = 4 * (2 * x_words + r_words + rows_l * (tw + 2 * halo))
    return ck_l, ck_e, nbp_l, nbp_e, x_words, r_words, smem


@lru_cache(maxsize=8)
def _multiprocessors(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_s1(lg, em, H: int, W: int, score_dtype, halo: int, c: float,
               lib=None):
    """S1 on CUDA tensors: (windowed uncertainty, radius, tile extremes).
    ``lib``: the library to launch from (the built kernels by default)."""
    global launches
    dev = lg.device
    (h, w, k_cls), (h2, w2, e_dim) = lg.shape, em.shape
    ck_l, ck_e, nbp_l, nbp_e, x_words, r_words, smem = plan(
        H, W, (h, w), (h2, w2), k_cls, e_dim, halo)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"region_score: a tile's input bands need {smem} "
                         f"bytes of shared memory (logits {(h, w)}, "
                         f"embedding {(h2, w2)} to {(H, W)}), above "
                         f"{_SMEM_LIMIT}")
    th, tw = TILE
    tiles = -(-H // th) * -(-W // tw)
    unc = torch.empty((H, W), dtype=torch.float32, device=dev)
    imp = torch.empty((H, W), dtype=torch.float32, device=dev)
    ext = torch.empty((tiles, 4), dtype=torch.float32, device=dev)
    tables = [device_table(H, h, dev), device_table(W, w, dev),
              device_table(H, h2, dev), device_table(W, w2, dev)]
    geom = (ctypes.c_longlong * 24)(
        int(lg.dtype == torch.bfloat16), *lg.stride(), h, w, k_cls,
        *em.stride(), h2, w2, e_dim, H, W, halo,
        int(score_dtype == torch.bfloat16), ck_l, ck_e, nbp_l, nbp_e,
        x_words, r_words, smem)
    sqrt_c = math.sqrt(c)
    fparams = (ctypes.c_float * 3)(sqrt_c, 2.0 / sqrt_c, _INV_LOG19)
    err = (lib or kernels.load()).halo_region_score_s1(
        lg.data_ptr(), em.data_ptr(), *(t.data_ptr() for t in tables),
        unc.data_ptr(), imp.data_ptr(), ext.data_ptr(),
        ctypes.addressof(geom), ctypes.addressof(fparams),
        kernels.current_stream(dev))
    kernels.check(err, "halo_region_score_s1")
    launches += 1
    return unc, imp, ext


def _launch_s2(unc, imp, ext, normalize: bool):
    """S2 on S1's outputs: score, and unc and imp normalised in place."""
    global launches_s2
    n = unc.numel()
    score = torch.empty_like(unc)
    grid = max(1, min(-(-n // 256), 4 * _multiprocessors(unc.device)))
    lib = kernels.load()
    err = lib.halo_region_score_s2(
        ext.data_ptr(), ext.shape[0], unc.data_ptr(), imp.data_ptr(),
        score.data_ptr(), n, int(normalize), grid,
        kernels.current_stream(unc.device))
    kernels.check(err, "halo_region_score_s2")
    launches_s2 += 1
    return score, imp, unc


def _cuda_operands(logits, embed, native_hw, score_dtype, halo: int):
    """The checked operands of a launch: (logits in float32 or bf16, the
    embedding in float32, H, W)."""
    if halo < 0 or halo > MAX_HALO:
        raise ValueError(f"region_score: window half-width {halo} is "
                         f"outside the kernel's 0..{MAX_HALO}")
    if embed.device != logits.device:
        raise ValueError("region_score: logits and embedding on "
                         f"{logits.device} and {embed.device}")
    if logits.dim() != 3 or embed.dim() != 3:
        raise ValueError("region_score: needs (h, w, C) logits and "
                         f"embedding, got {tuple(logits.shape)} and "
                         f"{tuple(embed.shape)}")
    if score_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"region_score: score dtype {score_dtype} is not "
                        "bf16/f32")
    H, W = int(native_hw[0]), int(native_hw[1])
    if H <= 0 or W <= 0 or H * W >= 2 ** 31 or 0 in logits.shape \
            or 0 in embed.shape:
        raise ValueError(f"region_score: empty or too large: native "
                         f"{(H, W)}, logits {tuple(logits.shape)}, "
                         f"embedding {tuple(embed.shape)}")
    lg = logits if logits.dtype in (torch.float32, torch.bfloat16) \
        else logits.float()
    return lg, embed.float(), H, W


def _route(logits, embed):
    if embed is None:
        raise ValueError("region_score: the radius needs an embedding")
    if logits.device.type == "cpu":
        return "plain"
    if logits.device.type != "cuda":
        raise ValueError(f"region_score: unsupported device {logits.device}")
    return "cuda"


def region_maps(logits, embed, native_hw, *, score_dtype=torch.bfloat16,
                halo: int = 1, c: float = 1.0):
    """(uncertainty, radius), each (H, W) float32 and not normalised, of
    one image: logits (h, w, classes), float32 or bf16 (other dtypes are
    widened to float32), and its ball embedding (h2, w2, E), any strides,
    at the native (H, W) with ``score_dtype`` bf16 or float32. The
    uncertainty is the (2 halo + 1)^2 window sum of the entropy (the
    entropy itself for halo 0). S1 alone on a CUDA tensor."""
    if _route(logits, embed) == "plain":
        return region_maps_plain(logits, embed, native_hw,
                                 score_dtype=score_dtype, halo=halo, c=c)
    lg, em, H, W = _cuda_operands(logits, embed, native_hw, score_dtype,
                                  halo)
    unc, rad, _ = _launch_s1(lg, em, H, W, score_dtype, halo, c)
    return unc, rad


def region_score(logits, embed, native_hw, *, score_dtype=torch.bfloat16,
                 halo: int = 1, c: float = 1.0, normalize: bool = True):
    """(score, impurity, uncertainty), each (H, W) float32: the maps of
    ``region_maps``, each min-max normalised when ``normalize``, and
    their product. S1 + S2 on a CUDA tensor."""
    if _route(logits, embed) == "plain":
        return region_score_plain(logits, embed, native_hw,
                                  score_dtype=score_dtype, halo=halo, c=c,
                                  normalize=normalize)
    lg, em, H, W = _cuda_operands(logits, embed, native_hw, score_dtype,
                                  halo)
    return _launch_s2(*_launch_s1(lg, em, H, W, score_dtype, halo, c),
                      normalize)
