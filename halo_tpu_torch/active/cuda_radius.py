"""Kernel B: the per-pixel Poincare radius map (CUDA).

Counterpart of ``halo_tpu/active/pallas_radius.py``. ``radius_map`` is the
wrapper: on a CUDA tensor it launches ``csrc/radius.cu`` (or raises); on a
CPU tensor it takes the plain version, ``radius_map_reference``, which is
``dist0(x.float())``. The kernel squares and sums in float32 like the plain
version, so the two differ by float32 summation order only.
"""

from __future__ import annotations

import math

import torch

from .. import kernels
from ..ops import hyperbolic as hyp

# Launches of the CUDA kernel, counted where it launches and nowhere else.
launches = 0


def radius_map_reference(embed, c: float = 1.0):
    """Plain version: dist0 of the float32 embedding over the last axis."""
    return hyp.dist0(embed.float(), c=c, dim=-1)


def radius_map(embed, c: float = 1.0):
    """(..., C) bf16 or f32 embedding -> (...) float32 distance to the
    origin of the Poincare ball of curvature ``c``."""
    if embed.device.type == "cpu":
        return radius_map_reference(embed, c)
    if embed.device.type != "cuda":
        raise ValueError(f"radius_map: unsupported device {embed.device}")
    entry = {torch.bfloat16: "halo_radius_map_bf16",
             torch.float32: "halo_radius_map_f32"}.get(embed.dtype)
    if entry is None:
        raise TypeError(f"radius_map: dtype {embed.dtype} is not bf16/f32")
    if embed.dim() < 1 or not embed.is_contiguous():
        raise ValueError("radius_map: needs a contiguous (..., C) tensor")
    channels = embed.shape[-1]
    out = torch.empty(embed.shape[:-1], dtype=torch.float32,
                      device=embed.device)
    n_pix = out.numel()
    if n_pix == 0:
        return out
    elems = 16 // embed.element_size()
    vectorized = int(channels % elems == 0 and embed.data_ptr() % 16 == 0)
    sqrt_c = math.sqrt(c)
    lib = kernels.load()
    err = getattr(lib, entry)(
        embed.data_ptr(), out.data_ptr(), n_pix, channels, vectorized,
        sqrt_c, 2.0 / sqrt_c, kernels.current_stream(embed.device))
    kernels.check(err, entry)
    global launches
    launches += 1
    return out
