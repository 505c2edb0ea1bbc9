"""Kernel Q's prologue (``ops.quant.quantize_fused``) and the models'
routes through it, on the CPU, at tiny sizes (``resnettiny``).

Expected:
  (a) the fused plain version (what the wrapper runs on a CPU tensor) bit
      for bit equal to the unfused ops it replaces: ``FrozenBatchNorm2d``,
      ``torch.relu``, then ``quantize_nhwc_plain``; float32 and bfloat16,
      NCHW and channels-last, C = 40 (no multiple of 16), NaN, +-inf and
      -0 in the input, amax 0;
  (b) several sources, one of them a (B, C, 1, 1) map broadcast with
      stride 0, bit for bit ``quantize_nhwc_plain`` of their
      ``torch.cat``; the CUDA branch (driven with a stand-in library) hands
      the kernel each source's pointer, channel offset, width and strides,
      the affine and the ReLU, and refuses what the kernel does not take;
  (c) against the JAX package: ``FrozenBatchNorm`` + ``jax.nn.relu`` +
      ``quantize_act``, compiled, on seeded numpy inputs: equal int8 values
      except where the float activation over sx lies within 1e-3 of a
      half-integer (the two packages' ``rsqrt`` may differ in the last
      bit, which moves such a value across the boundary), and never more
      than one step apart;
  (d) the routing: in an int8 model the fused route runs at exactly the
      sites whose norm is a ``FrozenBatchNorm2d`` and whose conv runs int8
      (each bottleneck's conv2 and conv3, each separable conv's pointwise
      conv; the ASPP bottleneck reads its five branches in place, with no
      ``torch.cat``), at none in train mode, in calibration or with a live
      ``BatchNorm2d``; the int8 forward bit for bit the unfused
      composition's.
"""

import contextlib
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo_tpu.models import layers as jax_layers
from halo_tpu.ops import quant as jax_quant
from halo_tpu_torch.config import get_default_cfg
from halo_tpu_torch.models import build_segmentor, layers
from halo_tpu_torch.models.resnet import Bottleneck
from halo_tpu_torch.ops import quant

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rng(seed):
    return np.random.default_rng(seed)


def _frozen_bn(c, seed):
    """A FrozenBatchNorm2d with seeded statistics and affine params."""
    rng = _rng(seed)
    bn = layers.FrozenBatchNorm2d(c)
    values = (rng.uniform(0.5, 1.5, c), rng.normal(size=c) * 0.3,
              rng.normal(size=c) * 0.3, rng.uniform(0.5, 2.0, c))
    with torch.no_grad():
        for name, v in zip(("weight", "bias", "running_mean", "running_var"),
                           values):
            getattr(bn, name).copy_(torch.from_numpy(v.astype(np.float32)))
    return bn


def _specials(x):
    """``x`` (float32 numpy) with NaN, +-inf and -0 at seeded places."""
    flat = x.reshape(-1)
    idx = _rng(1).choice(flat.size, 16, replace=False)
    flat[idx] = [np.nan, np.inf, -np.inf, -0.0] * 4
    return x


# ---------------------------------------------------------------------------
# (a) the fused plain version against the unfused ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prologue", ["norm+relu", "norm", "relu"])
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("amax_kind", ["clipping", "zero"])
def test_fused_plain_is_the_unfused_ops(prologue, layout, dtype, amax_kind):
    c = 40
    x = _specials(_rng(2).normal(size=(2, c, 7, 9)).astype(np.float32) * 2)
    t = torch.from_numpy(x).to(DTYPES[dtype])
    if layout == "channels_last":
        t = t.contiguous(memory_format=torch.channels_last)
    amax = torch.tensor(2.5 if amax_kind == "clipping" else 0.0)
    bn = _frozen_bn(c, 3)
    norm = "norm" in prologue
    relu = "relu" in prologue
    want = bn(t) if norm else t
    want = quant.quantize_nhwc_plain(torch.relu(want) if relu else want,
                                     amax)
    scale, shift = bn.affine(t.dtype) if norm else (None, None)
    got = quant.quantize_fused([t], amax, scale, shift, relu)
    assert got.shape == (2, 7, 9, 48) and got.dtype == torch.int8
    assert torch.equal(got, want)
    assert not got[..., c:].any()
    assert torch.equal(got, quant.quantize_fused_plain([t], amax, scale,
                                                       shift, relu))
    if amax_kind == "zero":   # every nonzero finite value clips
        assert int((got[..., :c].abs() == 127).sum()) > t.numel() // 3


def test_affine_is_forwards_and_follows_the_buffers():
    """``affine`` is ``forward``'s scale and shift in the dtype, made once
    a dtype, and made again when a buffer changes or is replaced."""
    bn = _frozen_bn(24, 4)
    x = torch.ones((1, 24, 1, 1))
    for dtype in DTYPES.values():
        scale, shift = bn.affine(dtype)
        assert scale.dtype == shift.dtype == dtype
        assert bn.affine(dtype)[0] is scale
        assert torch.equal(bn(x.to(dtype)).reshape(-1),
                           (scale * 1 + shift))
    kept = bn.affine(torch.float32)[0]
    bn.load_state_dict(_frozen_bn(24, 5).state_dict())
    scale, shift = bn.affine(torch.float32)
    assert scale is not kept
    assert torch.equal(bn(x).reshape(-1), scale + shift)
    bn.running_var = bn.running_var * 2          # a replaced buffer
    scale, _ = bn.affine(torch.float32)
    assert torch.equal(scale, bn._scale_shift()[0])
    assert "_affine" not in "".join(bn.state_dict())


# ---------------------------------------------------------------------------
# (b) several sources
# ---------------------------------------------------------------------------

def _aspp_sources(dtype, b=2, h=5, w=7):
    """The ASPP bottleneck's input as the model hands it over: a pooled
    (B, 48, 1, 1) map expanded over the pixels (strides 0) and channels-
    last branches, plus an NCHW one."""
    rng = _rng(6)
    pooled = torch.from_numpy(rng.normal(size=(b, 48, 1, 1)).astype(
        np.float32)).to(dtype)
    parts = [torch.from_numpy(rng.normal(size=(b, c, h, w)).astype(
        np.float32)).to(dtype) for c in (32, 64, 16)]
    parts[0] = parts[0].contiguous(memory_format=torch.channels_last)
    parts[1] = parts[1].contiguous(memory_format=torch.channels_last)
    return [pooled.expand(-1, -1, h, w)] + parts


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("prologue", [False, True])
def test_sources_are_the_concatenation(dtype, prologue):
    sources = _aspp_sources(DTYPES[dtype])
    assert sources[0].stride()[2:] == (0, 0)
    amax = torch.tensor(1.75)
    cat = torch.cat(sources, dim=1)
    bn = _frozen_bn(cat.shape[1], 7)
    if prologue:
        want = quant.quantize_nhwc_plain(torch.relu(bn(cat)), amax)
        got = quant.quantize_fused(sources, amax, *bn.affine(cat.dtype),
                                   relu=True)
    else:
        want = quant.quantize_nhwc_plain(cat, amax)
        got = quant.quantize_fused(sources, amax)
    assert got.shape == (2, 5, 7, 160) and torch.equal(got, want)


class _Library:
    """A stand-in kernel library: records what the wrapper hands
    ``halo_int8_quantize``."""

    def __init__(self):
        self.calls = []

    def halo_int8_quantize(self, n, desc, *args):
        # desc: the address of n x 7 int64, alive while the entry runs
        self.calls.append((n, list((ctypes.c_longlong * (7 * n))
                                   .from_address(desc)), args))
        return 0


@pytest.fixture
def cuda_branch(monkeypatch):
    """``quantize_fused``'s CUDA branch driven with CPU tensors taken for
    CUDA ones; the plain versions refuse."""
    from halo_tpu_torch import kernels

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the CUDA path")

    lib = _Library()
    monkeypatch.setattr(quant, "_device_is_cuda", lambda t, name: True)
    monkeypatch.setattr(quant, "quantize_fused_plain", refuse)
    monkeypatch.setattr(quant, "quantize_nhwc_plain", refuse)
    monkeypatch.setattr(kernels, "load", lambda: lib)
    monkeypatch.setattr(kernels, "current_stream", lambda device: 0)
    return lib


def test_cuda_branch_hands_the_kernel_every_source(cuda_branch):
    sources = _aspp_sources(torch.bfloat16)
    amax = torch.tensor(1.0)
    bn = _frozen_bn(160, 8)
    scale, shift = bn.affine(torch.bfloat16)
    n, nf = quant.quant_launches, quant.fused_launches
    got = quant.quantize_fused(sources, amax, scale, shift, relu=True)
    assert got.shape == (2, 5, 7, 160) and got.dtype == torch.int8
    (count, desc, args), = cuda_branch.calls
    assert count == 4 and len(desc) == 28
    c0 = 0
    for i, src in enumerate(sources):
        assert desc[7 * i: 7 * i + 7] == [src.data_ptr(), c0, src.shape[1],
                                          *src.stride()]
        c0 += src.shape[1]
    (x_bf16, amax_ptr, scale_ptr, shift_ptr, relu, q_ptr, b, h, w, cp, eps,
     inv127, stream) = args
    assert (x_bf16, relu, b, h, w, cp) == (1, 1, 2, 5, 7, 160)
    assert (amax_ptr, scale_ptr, shift_ptr, q_ptr) == (
        amax.data_ptr(), scale.data_ptr(), shift.data_ptr(), got.data_ptr())
    assert (quant.quant_launches, quant.fused_launches) == (n + 1, nf + 1)
    quant.quantize_nhwc(sources[1], amax)        # no prologue: not fused
    (count, desc, args), = cuda_branch.calls[1:]
    assert count == 1 and desc[1:3] == [0, 32] and args[2:5] == (None,
                                                                 None, 0)
    assert args[-4] == 32
    assert (quant.quant_launches, quant.fused_launches) == (n + 2, nf + 1)


def test_cuda_branch_refuses_before_launching(cuda_branch):
    x = torch.zeros((1, 32, 4, 4))
    amax = torch.tensor(1.0)
    scale = torch.ones(32)
    for bad in (
            lambda: quant.quantize_fused([x] * 6, amax),
            lambda: quant.quantize_fused([x, x.double()], amax),
            lambda: quant.quantize_fused([x, x[:, :, :2]], amax),
            lambda: quant.quantize_fused([x], amax, scale, None),
            lambda: quant.quantize_fused([x], amax, scale.double(), scale),
            lambda: quant.quantize_fused([x, x], amax, scale, scale),
            lambda: quant.quantize_fused([x], amax.double())):
        with pytest.raises(ValueError):
            bad()
    with pytest.raises(TypeError):
        quant.quantize_fused([x.half()], amax)
    assert not cuda_branch.calls


# ---------------------------------------------------------------------------
# (c) against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("amax_scale", [1.0, 0.5, 0.0])
def test_fused_matches_jax_frozen_bn_relu_quantize(dtype, amax_scale):
    c = 40
    rng = _rng(9)
    x = rng.normal(size=(2, 9, 11, c)).astype(np.float32) * 2
    x[0, 0, :4, 0] = [np.inf, -np.inf, -0.0, 0.0]
    bn = _frozen_bn(c, 10)
    frozen = {k: v.numpy() for k, v in bn.state_dict().items()}
    amax = np.float32(np.abs(x[np.isfinite(x)]).max() * amax_scale)
    jdtype = getattr(jnp, dtype)
    jx = jnp.asarray(x, jdtype)
    module = jax_layers.FrozenBatchNorm(c)
    want, sx = jax.jit(lambda v, x, a: jax_quant.quantize_act(
        jax.nn.relu(module.apply({"frozen": v}, x)), a))(
            frozen, jx, jnp.float32(amax))
    want = np.asarray(want)
    t = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        DTYPES[dtype]).permute(0, 3, 1, 2)
    got = quant.quantize_fused([t], torch.tensor(amax),
                               *bn.affine(t.dtype), relu=True)
    got = got[..., :c].numpy()
    # the port's float activation over sx at each differing value
    y = torch.relu(bn(t)).float().permute(0, 2, 3, 1).numpy()
    ratio = y / np.float32(sx)
    bad = np.argwhere(got != want)
    for idx in map(tuple, bad):
        assert abs(int(got[idx]) - int(want[idx])) == 1, idx
        frac = ratio[idx] - np.floor(ratio[idx])
        assert abs(frac - 0.5) < 1e-3, (idx, ratio[idx])
    assert len(bad) <= got.size // 1000
    if amax_scale == 0.0:
        assert int((np.abs(got) == 127).sum()) > got.size // 3


# ---------------------------------------------------------------------------
# (d) the routing
# ---------------------------------------------------------------------------

def _model(freeze_bn=True, quant_eval=True):
    cfg = get_default_cfg()
    cfg.MODEL.NAME = "deeplabv3plus_resnettiny"
    cfg.MODEL.HYPER = True
    cfg.MODEL.HFR = True
    cfg.MODEL.REDUCED_CHANNELS = 16
    cfg.MODEL.WEIGHTS = ""
    cfg.MODEL.FREEZE_BN = freeze_bn
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.QUANT_EVAL = quant_eval
    model = build_segmentor(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(12))
    rng = _rng(13)
    with torch.no_grad():   # statistics that make the affine matter
        for mod in model.modules():
            if isinstance(mod, (layers.FrozenBatchNorm2d,
                                torch.nn.BatchNorm2d)):
                c = mod.weight.numel()
                for name, v in (("weight", rng.uniform(0.5, 1.5, c)),
                                ("bias", rng.normal(size=c) * 0.1),
                                ("running_mean", rng.normal(size=c) * 0.1),
                                ("running_var", rng.uniform(0.5, 2.0, c))):
                    getattr(mod, name).copy_(torch.from_numpy(
                        v.astype(np.float32)))
    return model.eval()


@contextlib.contextmanager
def _watch(model, monkeypatch):
    """Record, for each launch of kernel Q, the QuantConv that made it,
    its sources and its prologue; count ``torch.cat`` calls."""
    launches, cats, current, inside = [], [0], [None], [False]
    names = {mod: name for name, mod in model.named_modules()}
    hooks = [mod.register_forward_pre_hook(
        lambda m, a: current.__setitem__(0, names[m]))
        for mod in model.modules() if isinstance(mod, layers.QuantConv)]
    fused, cat = quant.quantize_fused, torch.cat

    def spy(sources, amax, scale=None, shift=None, relu=False):
        launches.append((current[0], len(sources), scale is not None,
                         bool(relu)))
        inside[0] = True     # the plain version's own cat is not counted
        try:
            return fused(sources, amax, scale, shift, relu)
        finally:
            inside[0] = False

    def counted_cat(*a, **k):
        cats[0] += not inside[0]
        return cat(*a, **k)

    monkeypatch.setattr(quant, "quantize_fused", spy)
    monkeypatch.setattr(torch, "cat", counted_cat)
    try:
        yield launches, cats
    finally:
        for h in hooks:
            h.remove()
        monkeypatch.undo()


def _unfused_forward(self, x, norm=None, relu=None):
    """QuantConv's forward by the unfused ops: the norm, the ReLU and the
    concatenation as modules and torch ops, then kernel Q on the result."""
    x = self.input_of(x, norm, relu)
    if self.training or self.calibrating or self._small_strided(x):
        return torch.nn.Conv2d.forward(self, x)
    y = quant.int8_conv(x, self.w_int8, self.w_scale, self.amax,
                        self.stride, self.padding, self.dilation,
                        out_dtype=self.out_dtype(x), packed=self.w_packed)
    return y if self.bias is None else y + self.bias.view(1, -1, 1, 1)


TRUNK_SITES = {f"feature_extractor.backbone.layer{i}.0.{conv}"
               for i in (1, 3, 4) for conv in ("conv2", "conv3")} | {
    "feature_extractor.backbone.layer2.0.conv3"}
HEAD_SITES = {f"classifier.parallel_branches.{i}.pointwise_conv"
              for i in (1, 2, 3)} | {
    f"classifier.decoder.{i}.pointwise_conv" for i in (0, 1)}


def test_int8_model_fuses_at_the_sites(monkeypatch):
    """resnettiny v3+ at 64x64, int8: the prologue runs at every
    bottleneck's conv2 and conv3 (not layer2.0's strided conv2, which runs
    float on this small grid) and every pointwise conv; the ASPP
    bottleneck reads its five branches as sources (the global one
    broadcast) with no torch.cat; the outputs equal the unfused
    composition's bit for bit."""
    model = _model()
    x = torch.from_numpy(_rng(14).normal(size=(1, 3, 64, 64)).astype(
        np.float32))
    quant.calibrate(model, [x])
    with torch.no_grad():
        with _watch(model, monkeypatch) as (launches, cats):
            got = model(x)
        fused = {name for name, _, scale, relu in launches if scale}
        assert all(relu for _, _, scale, relu in launches if scale)
        assert fused == TRUNK_SITES | HEAD_SITES
        aspp = [n for name, n, *_ in launches
                if name == "classifier.bottleneck.0"]
        assert aspp == [5]
        # the decoder's concatenation of the low-level shortcut, which the
        # float depthwise conv reads, is the forward's one torch.cat
        assert cats[0] == 1
        # one launch a quantised layer but layer2.0's strided convs, which
        # run float on this small grid
        strided = {f"feature_extractor.backbone.layer2.0.{n}"
                   for n in ("conv2", "downsample.0")}
        assert sorted(name for name, *_ in launches) == sorted(
            set(dict(quant.quant_layers(model))) - strided)
        monkeypatch.setattr(layers.QuantConv, "forward", _unfused_forward)
        want = model(x)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_strided_bottleneck_fuses_on_a_large_grid(monkeypatch):
    """layer2.0's block with its strided conv2 at 2304 output positions:
    conv2 and conv3 both take the prologue; bit for bit the unfused
    composition's."""
    block = Bottleneck(256, 128, stride=2, has_downsample=True,
                       freeze_bn=True, quant=True).eval()
    for bn in (block.bn1, block.bn2, block.bn3, block.downsample[1]):
        fresh = _frozen_bn(bn.weight.numel(), 15)
        bn.load_state_dict(fresh.state_dict())
    x = torch.from_numpy(_rng(16).normal(size=(1, 256, 96, 96)).astype(
        np.float32))
    quant.calibrate(block, [x])
    with torch.no_grad():
        with _watch(block, monkeypatch) as (launches, _):
            got = block(x)
        assert sorted(launches) == [("conv1", 1, False, False),
                                    ("conv2", 1, True, True),
                                    ("conv3", 1, True, True),
                                    ("downsample.0", 1, False, False)]
        monkeypatch.setattr(layers.QuantConv, "forward", _unfused_forward)
        want = block(x)
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["train", "calibration", "live_bn",
                                  "float_build"])
def test_no_prologue_outside_int8_with_frozen_bn(mode, monkeypatch):
    """Train mode, calibration, a live BatchNorm2d (its eval formula is
    ATen's) and the float build never take the prologue; the live-BN int8
    model still runs kernel Q on every quantised layer, after the norm."""
    model = _model(freeze_bn=mode != "live_bn",
                   quant_eval=mode != "float_build")
    x = torch.from_numpy(_rng(17).normal(size=(1, 3, 64, 64)).astype(
        np.float32))
    if mode not in ("train", "float_build"):
        quant.calibrate(model, [x])
    if mode == "train":
        model.train()
    with torch.no_grad(), _watch(model, monkeypatch) as (launches, _):
        if mode == "calibration":
            quant.calibrate(model, [x])
        else:
            model(x)
    assert not any(scale or relu for *_, scale, relu in launches)
    if mode == "live_bn":   # all but layer2.0's two strided convs
        assert len(launches) == len(quant.quant_layers(model)) - 2
    else:
        assert not launches
