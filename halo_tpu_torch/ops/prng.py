"""JAX's default counter-based random bits, on torch tensors.

The ``random`` control arm of the acquisition round scores each image
with ``jax.random.uniform(jax.random.PRNGKey(seed), (H, W), float32)``
(``halo_tpu/active/region_selection.py:162``). ``uniform`` here gives the
same bits on any device: threefry-2x32 (20 rounds) of the key over the
flat element index, split into two 32-bit counter words, as JAX computes
it with ``jax_threefry_partitionable`` on; the two output words XORed;
the top 23 bits as the mantissa of a float in [1, 2), minus 1.

torch has no unsigned 32-bit arithmetic, so every word is an int64 tensor
masked to 32 bits after each addition and rotation.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & _MASK


def threefry2x32(key, x0, x1):
    """Threefry-2x32 of the counter words ``(x0, x1)`` (int64 tensors
    holding uint32 values) under ``key = (k0, k1)`` (Python ints): the
    two output words, as int64 tensors."""
    k0, k1 = int(key[0]) & _MASK, int(key[1]) & _MASK
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def uniform(seed: int, shape, device=None):
    """``jax.random.uniform(jax.random.PRNGKey(seed), shape, float32)``,
    bit for bit, for a seed below 2**32 (whose key is (0, seed)): float32
    in [0, 1)."""
    if not 0 <= int(seed) <= _MASK:
        raise ValueError(f"uniform: seed {seed} is not a uint32")
    n = 1
    for s in shape:
        n *= int(s)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    hi, lo = threefry2x32((0, int(seed)), idx >> 32, idx & _MASK)
    bits = (hi ^ lo).reshape(tuple(shape))
    one = 0x3F800000  # float32 1.0
    floats = ((bits >> 9) | one).to(torch.int32).view(torch.float32)
    return floats - 1.0
