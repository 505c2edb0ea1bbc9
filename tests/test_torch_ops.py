"""Port parity, ops: halo_tpu_torch.ops against halo_tpu.ops on the same
seeded float32 inputs. The formulas are the same; only summation order
differs, hence rtol = atol = 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo_tpu.ops import hyperbolic as jhyp
from halo_tpu.ops.resize import resize_bilinear as jresize
from halo_tpu.ops.resize import resize_nearest as jnearest
from halo_tpu_torch.ops import hyperbolic as thyp
from halo_tpu_torch.ops.resize import resize_bilinear as tresize
from halo_tpu_torch.ops.resize import resize_nearest as tnearest

TOL = dict(rtol=1e-6, atol=1e-6)


def _both(x):
    x = np.asarray(x, np.float32)
    return jnp.asarray(x, jnp.float32), torch.from_numpy(x.copy())


def _close(jax_out, torch_out):
    np.testing.assert_allclose(torch_out.numpy(), np.asarray(jax_out), **TOL)


@pytest.mark.parametrize("c", [1.0, 0.5])
def test_expmap_project_dist0(c):
    rng = np.random.default_rng(0)
    u = rng.normal(scale=2.0, size=(6, 7, 16)).astype(np.float32)
    u[0, 0] = 0.0  # the clamped zero norm
    ju, tu = _both(u)
    _close(jhyp.expmap(ju, c=c), thyp.expmap(tu, c=c))
    _close(jhyp.project(ju, c=c), thyp.project(tu, c=c))  # most clip
    # dist0 away from the boundary, where artanh is well conditioned
    ball = np.asarray(jhyp.expmap(ju * 0.15, c=c))
    jb, tb = _both(ball)
    _close(jhyp.dist0(jb, c=c), thyp.dist0(tb, c=c))


def test_hyper_mlr_logits():
    rng = np.random.default_rng(1)
    x = np.asarray(jhyp.expmap(jnp.asarray(
        rng.normal(scale=0.15, size=(5, 9, 16)), jnp.float32)))
    p = rng.uniform(-0.25, 0.25, (19, 16)).astype(np.float32)
    a = rng.uniform(-0.25, 0.25, (19, 16)).astype(np.float32)
    jx, tx = _both(x)
    jp, tp = _both(p)
    ja, ta = _both(a)
    want = jhyp.hyper_mlr_logits(jx, jp, ja, c=1.0,
                                 precision=jax.lax.Precision.HIGHEST)
    _close(want, thyp.hyper_mlr_logits(tx, tp, ta, c=1.0))


@pytest.mark.parametrize("in_hw,out_hw", [((5, 7), (17, 23)),
                                          ((40, 80), (300, 520)),
                                          ((9, 9), (9, 9))])
def test_resize_bilinear(in_hw, out_hw):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2,) + in_hw + (3,)).astype(np.float32)
    jx, tx = _both(x)
    _close(jresize(jx, out_hw), tresize(tx, out_hw))


def _ball_pair(seed, c, shape=(5, 9, 16)):
    """Two float32 point sets inside the ball, away from its edge."""
    rng = np.random.default_rng(seed)
    return [np.array(jhyp.expmap(jnp.asarray(
        rng.normal(scale=0.2, size=shape), jnp.float32), c=c))
        for _ in range(2)]


@pytest.mark.parametrize("c", [1.0, 0.5])
def test_logmap0_mobius_add_dist(c):
    x, y = _ball_pair(3, c)
    x[0, 0] = 0.0  # the clamped zero norm
    (jx, tx), (jy, ty) = _both(x), _both(y)
    _close(jhyp.logmap0(jx, c=c), thyp.logmap0(tx, c=c))
    _close(jhyp.mobius_add(jx, jy, c=c), thyp.mobius_add(tx, ty, c=c))
    _close(jhyp.dist(jx, jy, c=c), thyp.dist(tx, ty, c=c))
    _close(jhyp.dist(jx, jy, c=c, keepdims=True),
           thyp.dist(tx, ty, c=c, keepdim=True))
    _close(jhyp.cosine_distance(jx, jy), thyp.cosine_distance(tx, ty))
    # logmap0 inverts expmap0 inside the ball
    _close(jhyp.expmap0(jhyp.logmap0(jx, c=c), c=c),
           thyp.expmap0(thyp.logmap0(tx, c=c), c=c))


def test_embedding_metrics():
    rng = np.random.default_rng(4)
    x = rng.normal(scale=0.3, size=(3, 7, 8)).astype(np.float32)
    y = rng.normal(scale=0.3, size=(3, 7, 8)).astype(np.float32)
    (jx, tx), (jy, ty) = _both(x), _both(y)
    want = jhyp.embedding_metrics(jx, jy, c=1.0)
    got = thyp.embedding_metrics(tx, ty, c=1.0)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("in_hw,out_hw", [((5, 7), (17, 23)),
                                          ((64, 128), (24, 48)),
                                          ((9, 9), (9, 9)),
                                          ((1024, 2048), (640, 1280))])
def test_resize_nearest(in_hw, out_hw):
    labels = np.random.default_rng(5).integers(0, 256, (2,) + in_hw + (1,))
    labels = labels.astype(np.uint8)
    want = np.asarray(jnearest(jnp.asarray(labels), out_hw))
    got = tnearest(torch.from_numpy(labels), out_hw)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
