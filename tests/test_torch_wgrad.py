"""Port parity, kernel C's weight gradient and the dx weight's repack.

The plain dk (``wgrad_taps``, what the CUDA weight-gradient kernel is held
to on the card, and what the wrapper takes on the CPU) against
``jax.grad`` of the JAX package's Pallas conv run in interpret mode, at
shapes whose H and W are not multiples of the kernel's 32 x 2 pixel step,
with C != Co and C = 32 or 96, d = 1, 3, 4 and B = 1, 2. Inputs are
float32, made with numpy. Tolerance: rtol 1e-5 and atol 1e-3, the JAX
package's own for this kernel's gradients (tests/test_dense_conv.py): each
dk entry sums up to B*H*W = 666 products of unit normals (|dk| ~ 26) in
float32, in another order on each side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo_tpu.ops import pallas_conv
from halo_tpu_torch.ops import dilated_conv as dc


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pallas_conv, "INTERPRET", True)


@pytest.mark.parametrize("b,h,w,c,co,d", [
    (1, 7, 13, 32, 96, 1),
    (2, 9, 37, 96, 32, 3),
    (1, 9, 37, 32, 64, 4),
    (2, 7, 13, 96, 160, 4),
    (2, 9, 37, 32, 96, 1),
])
def test_plain_dk_matches_jax_grad(interpret, b, h, w, c, co, d):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    k = (rng.normal(size=(3, 3, c, co)) * 0.05).astype(np.float32)
    g = rng.normal(size=(b, h, w, co)).astype(np.float32)
    gx_j, gk_j = jax.grad(
        lambda x, k: jnp.sum(pallas_conv.dilated_conv3x3(x, k, d) * g),
        (0, 1))(jnp.asarray(x), jnp.asarray(k))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    gt = torch.from_numpy(g).permute(0, 3, 1, 2)
    wt = torch.from_numpy(k).permute(3, 2, 0, 1)
    dk = dc.wgrad_taps(xt, gt, d)
    assert dk.shape == (co, c, 3, 3) and dk.dtype == torch.float32
    np.testing.assert_allclose(dk.permute(2, 3, 1, 0).numpy(),
                               np.asarray(gk_j), rtol=1e-5, atol=1e-3)
    # the autograd Function on the CPU takes the same plain dk, launches
    # nothing and counts nothing
    xr = xt.clone().requires_grad_(True)
    wr = wt.clone().requires_grad_(True)
    launches = (dc.launches_fwd, dc.launches_dx, dc.launches_dk)
    dc.dilated_conv3x3(xr, wr, d).backward(gt)
    assert (dc.launches_fwd, dc.launches_dx, dc.launches_dk) == launches
    torch.testing.assert_close(wr.grad, dk, rtol=0, atol=0)
    np.testing.assert_allclose(xr.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(gx_j), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("kmajor", [True, False])
def test_flipped_repack_is_the_two_step_form(dtype, channels_last, kmajor):
    """repack_flipped (one copy) equals the repack of the flipped,
    IO-transposed weight (two copies) bit for bit, for the bf16 kernel's
    K-major layout and the f32 kernel's, whatever the weight's layout."""
    rng = np.random.default_rng(3)
    weight = torch.from_numpy(
        rng.normal(size=(96, 32, 3, 3)).astype(np.float32)).to(dtype)
    if channels_last:
        weight = weight.contiguous(memory_format=torch.channels_last)
    two_step = weight.flip(2, 3).transpose(0, 1)
    want = dc.repack_kmajor(two_step) if kmajor else dc.repack(two_step)
    got = dc.repack_flipped(weight, kmajor=kmajor)
    assert got.shape == want.shape == ((9, 32, 96) if kmajor else
                                       (9, 96, 32))
    assert got.is_contiguous() and got.dtype == dtype
    assert torch.equal(got.view(torch.int16) if dtype == torch.bfloat16
                       else got.view(torch.int32),
                       want.view(torch.int16) if dtype == torch.bfloat16
                       else want.view(torch.int32))


@pytest.mark.parametrize("channels_last", [False, True])
def test_kmajor_repack_addresses_the_weight(channels_last):
    """The bf16 forward's operand B, the (9, Co, C) repack: contiguous,
    entry [3i+j, o, c] = weight[o, c, i, j], whatever the weight's
    layout (the models hold theirs channels_last on CUDA)."""
    rng = np.random.default_rng(5)
    weight = torch.from_numpy(
        rng.normal(size=(96, 64, 3, 3)).astype(np.float32)).bfloat16()
    if channels_last:
        weight = weight.contiguous(memory_format=torch.channels_last)
    w = dc.repack_kmajor(weight)
    assert w.shape == (9, 96, 64) and w.is_contiguous()
    tap, o, c = np.meshgrid(np.arange(9), np.arange(96), np.arange(64),
                            indexing="ij")
    want = weight[torch.from_numpy(o.ravel()), torch.from_numpy(c.ravel()),
                  torch.from_numpy(tap.ravel() // 3),
                  torch.from_numpy(tap.ravel() % 3)]
    assert torch.equal(w.reshape(-1).view(torch.int16),
                       want.view(torch.int16))
