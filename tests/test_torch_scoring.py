"""Port parity, scoring: halo_tpu_torch.active.scoring against
halo_tpu.active.scoring on the same seeded float32 inputs (score maps
within 1e-5), and kernel B's plain version against the Pallas radius
kernel in interpret mode (within 1e-6 relative)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo_tpu.active import scoring as js
from halo_tpu.active.pallas_radius import radius_map as pallas_radius_map
from halo_tpu.ops import hyperbolic as jhyp
from halo_tpu_torch.active import cuda_radius
from halo_tpu_torch.active import scoring as ts

TOL = dict(rtol=0, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return jnp.asarray(x)


def _ball(rng, shape, lo=0.0, hi=0.9):
    """Points of the Poincare ball, radii uniform in [lo, hi)."""
    x = rng.normal(size=shape)
    r = rng.uniform(lo, hi, shape[:-1] + (1,))
    return (x / np.linalg.norm(x, axis=-1, keepdims=True) * r).astype(
        np.float32)


@pytest.mark.parametrize("precise", [False, True])
def test_entropy_from_logits(precise):
    x = (np.random.default_rng(0).normal(size=(12, 14, 19)) * 3).astype(
        np.float32)
    np.testing.assert_allclose(
        ts.entropy_from_logits(_t(x), precise).numpy(),
        np.asarray(js.entropy_from_logits(_j(x), precise)), **TOL)


@pytest.mark.parametrize("shape,size", [((12, 14), 3), ((12, 14, 5), 5)])
def test_box_filter(shape, size):
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    np.testing.assert_allclose(ts.box_filter(_t(x), size).numpy(),
                               np.asarray(js.box_filter(_j(x), size)),
                               rtol=0, atol=1e-6)


def test_region_impurity():
    pred = np.random.default_rng(2).integers(0, 7, (12, 14)).astype(
        np.int32)
    t_imp, t_cnt = ts.region_impurity(_t(pred), 7, 3)
    j_imp, j_cnt = js.region_impurity(_j(pred), 7, 3)
    np.testing.assert_allclose(t_imp.numpy(), np.asarray(j_imp), **TOL)
    np.testing.assert_array_equal(t_cnt.numpy(), np.asarray(j_cnt))


@pytest.mark.parametrize("unc,pur", [("entropy", "radius"),
                                     ("entropy", "hyper"),
                                     ("pixel_entropy", "ripu"),
                                     ("oracle_acc", "oracle_ripu"),
                                     ("none", "euc_norm")])
def test_floating_region_score(unc, pur):
    rng = np.random.default_rng(3)
    H, W, C = 12, 14, 5
    logits = (rng.normal(size=(H, W, C)) * 2).astype(np.float32)
    embed = _ball(rng, (H, W, 8))
    gt = rng.integers(0, C, (H, W)).astype(np.int32)
    gt[0, :3] = 255
    opts = dict(unc_type=unc, pur_type=pur, size=3, num_classes=C, K=10)
    got = ts.floating_region_score(_t(logits), _t(embed), _t(gt), **opts)
    want = js.floating_region_score(_j(logits), _j(embed), _j(gt), **opts)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_fused_upsample_region_score():
    """Banded row blocks (two full 128-row blocks and a short tail) and a
    banded W contraction (W >= 256), float32 maps."""
    rng = np.random.default_rng(4)
    logits = (rng.normal(size=(8, 12, 19)) * 2).astype(np.float32)
    embed = _ball(rng, (4, 6, 16))
    native = (260, 300)
    got = ts.fused_upsample_region_score(
        _t(logits), _t(embed), native, score_dtype=torch.float32)
    want = js.fused_upsample_region_score(
        _j(logits), _j(embed), native, score_dtype=jnp.float32)
    for g, w in zip(got, want):
        assert g.shape == native
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_radius_plain_version_matches_pallas_kernel():
    """Kernel B's plain version (the wrapper's CPU path) against
    pallas_radius.radius_map(interpret=True, variant='vpu'), both with
    float32 squares, on a bf16 (16, 128, 64) map."""
    x = _ball(np.random.default_rng(5), (16, 128, 64), lo=0.3)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    np.testing.assert_array_equal(
        np.asarray(jx.astype(jnp.float32)), tx.float().numpy())
    want = np.asarray(pallas_radius_map(jx, interpret=True, variant="vpu"))
    got = cuda_radius.radius_map(tx)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jhyp.dist0(jx.astype(jnp.float32))),
        rtol=1e-6, atol=0)
