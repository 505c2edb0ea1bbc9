"""Port parity, kernel C: the port's dilated 3x3 conv (its plain version,
which the wrapper takes on the CPU, and its autograd.Function) against the
JAX package's Pallas kernel run in interpret mode, plus the routing rule.
Inputs are float32, made with numpy; tolerances are the JAX package's own
for this kernel (tests/test_dense_conv.py): forward rtol 1e-5 / atol 1e-4,
gradients rtol 1e-5 / atol 1e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo_tpu.ops import pallas_conv
from halo_tpu_torch.config import get_default_cfg
from halo_tpu_torch.models import build_segmentor
from halo_tpu_torch.models.layers import (DilatedConv3x3,
                                          dilated_conv_eligible)
from halo_tpu_torch.ops import dilated_conv as dc


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pallas_conv, "INTERPRET", True)


def _case(seed, shape, cout):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    k = (rng.normal(size=(3, 3, shape[-1], cout)) * 0.05).astype(np.float32)
    g = rng.normal(size=shape[:-1] + (cout,)).astype(np.float32)
    return x, k, g


def _to_torch(x, k):
    """NHWC / HWIO numpy -> NCHW input and (Co, C, 3, 3) weight."""
    return (torch.from_numpy(x).permute(0, 3, 1, 2),
            torch.from_numpy(k).permute(3, 2, 0, 1))


@pytest.mark.parametrize("d", [1, 2, 4])
def test_plain_forward_matches_jax_kernel(interpret, d):
    x, k, _ = _case(4, (2, 16, 32, 128), 128)
    want = pallas_conv.dilated_conv3x3(jnp.asarray(x), jnp.asarray(k), d)
    xt, wt = _to_torch(x, k)
    got = dc.dilated_conv3x3(xt, wt, d)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(
        got.numpy(), dc.dilated_conv3x3_plain(xt, wt, d).numpy())


@pytest.mark.parametrize("d", [1, 2])
def test_kmajor_packing_matches_weight_and_jax_kernel(interpret, d):
    """The bf16 kernel's operand B, (9, Co, C) with C innermost: entry
    [3i+j, o, c] is weight[o, c, i, j], and the nine tap products over it
    (what the kernel sums) give the JAX kernel's conv."""
    x, k, _ = _case(5, (1, 8, 16, 64), 96)
    xt, wt = _to_torch(x, k)
    wk = dc.repack_kmajor(wt)
    assert wk.shape == (9, 96, 64) and wk.is_contiguous()
    for o, c, i, j in ((0, 0, 0, 0), (95, 63, 2, 2), (17, 40, 1, 2),
                       (50, 3, 2, 0)):
        assert float(wk[3 * i + j, o, c]) == float(wt[o, c, i, j])
    torch.testing.assert_close(wk.transpose(1, 2), dc.repack(wt), rtol=0,
                               atol=0)
    taps = dc._taps(xt.permute(0, 2, 3, 1), d)
    got = sum(slab @ wk[t].t() for t, slab in enumerate(taps))
    want = pallas_conv.dilated_conv3x3(jnp.asarray(x), jnp.asarray(k), d)
    np.testing.assert_allclose(got.reshape(1, 8, 16, 96).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape,cout", [
    ((1, 8, 16, 128), 128),
    ((1, 8, 16, 128), 256),   # Cin != Cout
])
def test_vjp_matches_jax_grad(interpret, shape, cout):
    d = 2
    x, k, g = _case(7, shape, cout)
    gx_j, gk_j = jax.grad(
        lambda x, k: jnp.sum(pallas_conv.dilated_conv3x3(x, k, d) * g),
        (0, 1))(jnp.asarray(x), jnp.asarray(k))
    xt, wt = _to_torch(x, k)
    xt.requires_grad_(True)
    wt.requires_grad_(True)
    y = dc.dilated_conv3x3(xt, wt, d)
    y.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(gx_j), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(wt.grad.permute(2, 3, 1, 0).numpy(),
                               np.asarray(gk_j), rtol=1e-5, atol=1e-3)
    assert wt.grad.dtype == torch.float32 and xt.grad.shape == xt.shape


def test_module_casts_and_keeps_conv2d_weight():
    conv = DilatedConv3x3(128, 128, 2)
    assert isinstance(conv, torch.nn.Conv2d) and conv.bias is None
    assert tuple(conv.weight.shape) == (128, 128, 3, 3)
    x = torch.randn(1, 128, 6, 10)
    want = torch.nn.functional.conv2d(x, conv.weight, padding=2, dilation=2)
    torch.testing.assert_close(conv(x), want, rtol=1e-5, atol=1e-4)
    # under autocast the input and the weight go in in the compute dtype,
    # and the gradient comes back to the float32 weight in float32
    with torch.autocast("cpu", dtype=torch.bfloat16):
        y = conv(x.requires_grad_(True))
    assert y.dtype == torch.bfloat16
    y.float().sum().backward()
    assert conv.weight.grad.dtype == torch.float32
    assert x.grad.dtype == torch.float32


def test_eligibility_mirrors_jax_rule():
    args = dict(channels=256, stride=1, dilation=2)
    assert dilated_conv_eligible("pallas", **args)
    # the default mode "conv" routes nothing
    assert not dilated_conv_eligible("conv", **args)
    # strided, undilated and unaligned-channel convs stay on nn.Conv2d
    for bad in (dict(stride=2), dict(dilation=1), dict(channels=96),
                dict(channels=192)):
        assert not dilated_conv_eligible("pallas", **{**args, **bad}), bad
    # the JAX rule's VMEM budget keeps layer4 at d=4 off the TPU kernel
    # (tests/test_dense_conv.py); the port has no such budget
    assert not pallas_conv.supports((1, 80, 160, 512), (3, 3, 512, 512), 4)
    assert dilated_conv_eligible("pallas", channels=512, stride=1,
                                 dilation=4)
    # whatever is eligible, the kernel takes in both dtypes
    for c in (128, 256, 512):
        for dtype in (torch.bfloat16, torch.float32):
            assert dc.supports((2, c, 90, 160), (c, c, 3, 3), 2, dtype)


@pytest.mark.parametrize("c,co,dtype,ok", [
    (256, 256, torch.bfloat16, True),
    (128, 256, torch.bfloat16, True),
    (64, 160, torch.bfloat16, True),
    (64, 40, torch.bfloat16, False),    # Co % 32: its dx could not launch
    (40, 64, torch.bfloat16, False),    # C % 32
    (48, 32, torch.float32, True),
    (48, 40, torch.float32, False),     # Co % 16: its dx could not launch
    (256, 256, torch.float16, False),   # no float16 instantiation
])
def test_supports_is_backward_safe(c, co, dtype, ok):
    """The shape rule is symmetric in C and Co: a forward it takes has an
    input gradient (the same kernel, C and Co swapped) it takes too."""
    assert dc.supports((2, c, 9, 11), (co, c, 3, 3), 2, dtype) is ok
    assert dc.supports((2, co, 9, 11), (c, co, 3, 3), 2, dtype) is ok
    assert not dc.supports((2, c, 9, 11), (co, c, 3, 3), 0, dtype)
    assert not dc.supports((2, c, 9, 11), (co, c + 1, 3, 3), 2, dtype)


@pytest.mark.parametrize("name,count", [("resnet101", 25), ("resnettiny", 1)])
def test_trunk_routes_dilated_convs(name, count):
    cfg = get_default_cfg()
    cfg.MODEL.NAME = f"deeplabv3plus_{name}"
    cfg.MODEL.REDUCED_CHANNELS = 16
    cfg.TPU.DENSE_CONV_MODE = "pallas"
    model = build_segmentor(cfg, device="cpu")
    convs = {n: m for n, m in model.named_modules()
             if isinstance(m, DilatedConv3x3)}
    assert len(convs) == count
    assert "feature_extractor.backbone.layer4.0.conv2" in convs
    cfg.TPU.DENSE_CONV_MODE = "conv"
    plain = build_segmentor(cfg, device="cpu")
    assert not any(isinstance(m, DilatedConv3x3) for m in plain.modules())
    # the same parameter names either way
    assert list(plain.state_dict()) == list(model.state_dict())

