"""Port parity, int8 (W8A8) evaluation: ``halo_tpu_torch/ops/quant.py``
and the quantised models against ``halo_tpu/ops/quant.py`` and the JAX
package's int8 builds, on seeded numpy inputs (float32, explicit: the
test conftest turns x64 on), at tiny sizes (``resnettiny``, ``mittiny``,
64x64 and 96x96).

Expected: ``quantize_weight`` and ``quantize_act`` bit for bit against
the JAX ops compiled (``jax.jit``, as every JAX caller runs them: XLA
computes ``absmax / 127.0`` as ``absmax * float32(1/127)``, which differs
from the division in the last bit of ~6% of the scales; the port computes
the product); ``int8_conv`` and ``int8_dense`` bit for bit against the
JAX ops' own arithmetic on those scales (int8 values, int32 sums, then
``float32(sum) * (sx * w_scale)``), and within one float32 ulp of the
whole JAX op compiled (XLA reassociates the product of the two scales
with the constant); the same quantised layers as the JAX
build, including the small-grid and narrow-input float rules; a quantised
build's ``state_dict`` is the float build's, and its train-mode forward
the float build's bit for bit; calibration's ``amax`` within 1e-6
relative of the JAX package's (the float32 forwards in front of a layer
sum in another order: up to 1.6e-6 measured over three seeds, through ~10
layers), its int8 weights and scales equal; with the JAX
calibration carried across, the int8 activations equal the JAX
package's but where a float input sits within 1e-3 of a rounding boundary
and downstream of such a one (each reported, never more than one step
apart), and the logits within 1e-4 of their max when no activation
differs, within 1e-2 when one does (one int8 step is 1/127 of a layer's
range).
Checkpoints: the JAX package's ``quant`` collection resumes calibrated,
the port's own round trip keeps the calibration, a calibration of another
layer set warns and is dropped, a float build ignores it.
"""

import functools
import pathlib
import tempfile

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from halo_tpu.config import get_default_cfg as jax_default_cfg
from halo_tpu.engine import state as jax_state
from halo_tpu.engine.optim import build_optimizer as jax_build_optimizer
from halo_tpu.models import layers as jax_layers
from halo_tpu.models.build import build_segmentor as jax_build_segmentor
from halo_tpu.ops import quant as jax_quant
from halo_tpu_torch.config import get_default_cfg
from halo_tpu_torch.engine.optim import build_optimizer
from halo_tpu_torch.engine.state import (load_module_params, restore_state,
                                         save_checkpoint)
from halo_tpu_torch.models import build_segmentor, variables_to_state_dict
from halo_tpu_torch.models import layers
from halo_tpu_torch.models.convert import _layer_name, quant_tree_to_state
from halo_tpu_torch.ops import quant


@pytest.fixture
def tmp_path():
    """A directory removed when the test ends, in place of pytest's kept
    one."""
    with tempfile.TemporaryDirectory() as d:
        yield pathlib.Path(d)


@pytest.fixture(autouse=True)
def jax_globals(monkeypatch):
    """The JAX package's build globals restored after each test."""
    for name in ("DENSE_CONV_MODE", "STENCIL_TRAIN", "CONV_WGRAD",
                 "QUANT_EVAL"):
        monkeypatch.setattr(jax_layers, name, getattr(jax_layers, name))


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _f32(a):
    return np.asarray(a, np.float32)


def _rng(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# The ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(40, 24, 3, 3), (24, 136)],
                         ids=["conv", "dense"])
def test_quantize_weight_matches_jax(shape):
    w = _rng(0).normal(size=shape).astype(np.float32)
    w[3] = 0.0                         # an all-zero output channel
    w[5] *= 1e-3
    got_q, got_s = quant.quantize_weight(torch.from_numpy(w))
    # the JAX layouts keep the output channel last: HWIO, (Cin, Cout)
    jw = w.transpose(2, 3, 1, 0) if w.ndim == 4 else w.T
    want_q, want_s = jax.jit(jax_quant.quantize_weight)(
        jnp.asarray(jw, jnp.float32))
    want_q = np.asarray(want_q)
    want_q = want_q.transpose(3, 2, 0, 1) if w.ndim == 4 else want_q.T
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert not got_q[3].any()


@pytest.mark.parametrize("amax", [None, 0.5, 0.0],
                         ids=["max", "clipping", "zero"])
def test_quantize_act_matches_jax(amax):
    x = _rng(1).normal(size=(2, 7, 9, 24)).astype(np.float32)
    a = np.float32(np.abs(x).max() if amax is None else amax)
    got, got_s = quant.quantize_act(torch.from_numpy(x), torch.tensor(a))
    want, want_s = jax.jit(jax_quant.quantize_act)(jnp.asarray(x),
                                                   jnp.float32(a))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(got_s) == float(want_s)
    if amax == 0.5:
        assert got.abs().max() == 127 and (got.abs() == 127).sum() > 10


# An absmax whose scale is a power of two: sx = fl32(15.875 * fl32(1/127))
# = 0.125 exactly, so (k + 0.5) * sx are exact ties in float32 and bf16.
_TIE_AMAX = 15.875


def _tie_input(rng, shape, amax):
    """float32 values of ``shape``: exact half-way points (k + 0.5) * sx,
    random values within +-amax, values beyond it and +-inf."""
    sx = 0.125
    x = rng.uniform(-amax, amax, size=shape).astype(np.float32)
    flat = x.reshape(-1)
    n = flat.size
    flat[: n // 3] = (rng.integers(-127, 127, n // 3) + 0.5) * sx
    flat[n // 3: n // 3 + 8] = [amax * 2, -amax * 2, amax * 1.01, -amax * 9,
                                np.inf, -np.inf, 0.0, -0.0]
    rng.shuffle(flat)
    return x


@pytest.mark.parametrize("layout", ["nchw", "channels_last", "tokens"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("amax_kind", ["ties", "zero"])
def test_quantize_nhwc_plain_matches_jax(layout, dtype, amax_kind):
    """Kernel Q's plain version (what ``quantize_nhwc`` runs on the CPU)
    bit for bit against the JAX ``quantize_act`` compiled: bf16 and f32
    input, NCHW, channels-last and (B, N, C) token input, values exactly on
    half-way points, beyond +-amax and infinite, amax = 0 (every nonzero
    value clips), and C = 24 zero-padded to 32."""
    rng = _rng(11)
    amax = np.float32(_TIE_AMAX if amax_kind == "ties" else 0.0)
    nhwc = _tie_input(rng, (2, 5, 7, 24), _TIE_AMAX)
    if dtype == "bfloat16":   # bf16 values, held exactly in float32
        nhwc = np.array(jnp.asarray(nhwc, jnp.bfloat16).astype(
            jnp.float32))
        ties = nhwc[np.abs(nhwc) < _TIE_AMAX] / np.float32(0.125)
        assert (ties % 1 == 0.5).sum() > 50   # the ties survive bf16
    t = torch.from_numpy(nhwc).to(getattr(torch, dtype))
    if layout == "nchw":
        x = t.permute(0, 3, 1, 2).contiguous()
    elif layout == "channels_last":
        x = t.permute(0, 3, 1, 2)
        assert x.is_contiguous(memory_format=torch.channels_last)
    else:
        x = quant._channels_view(t.reshape(2, 35, 24))
        assert x.shape == (1, 24, 2, 35)
    got = quant.quantize_nhwc(x, torch.tensor(amax))
    want, _ = jax.jit(jax_quant.quantize_act)(
        jnp.asarray(nhwc, getattr(jnp, dtype)), jnp.float32(amax))
    got = got.reshape(70, 32).numpy()
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got[:, :24], np.asarray(want).reshape(70,
                                                                        24))
    assert not got[:, 24:].any()
    if amax_kind == "zero":
        assert (np.abs(got[:, :24]) == 127).sum() == (nhwc != 0).sum()
    else:
        assert (np.abs(got[:, :24]) == 127).sum() >= 6


@pytest.mark.parametrize("shape", [(40, 24, 3, 3), (37, 20, 1, 1),
                                   (33, 136, 1, 1), (64, 64, 5, 3)])
def test_pack_weight_round_trips(shape):
    """Kernel I's weight operand: (Cop, kh*kw*Cp), Co padded to a
    multiple of 8 and Cin to one of 16 with zeros; it unpacks to
    ``w_int8``."""
    w_q, _ = quant.quantize_weight(torch.from_numpy(
        _rng(12).normal(size=shape).astype(np.float32)))
    co, c, kh, kw = shape
    cop, cp = -(-co // 8) * 8, -(-c // 16) * 16
    packed = quant.pack_weight(w_q)
    assert packed.shape == (cop, kh * kw * cp) and packed.is_contiguous()
    assert torch.equal(quant.unpack_weight(packed, co, c, kh, kw), w_q)
    full = quant.unpack_weight(packed, cop, cp, kh, kw)
    assert not full[co:].any() and not full[:, c:].any()
    assert int((packed != 0).sum()) == int((w_q != 0).sum())


# (kernel, stride, padding, dilation[, Co]); amax at max|x|, below it
# (clips), and 0
CONVS = [(3, 1, 1, 1), (3, 1, 2, 2), (3, 1, 4, 4), (3, 2, 1, 1),
         (1, 1, 0, 1), (1, 2, 0, 1), (1, 1, 0, 1, 37), (3, 2, 1, 1, 37)]


@pytest.mark.parametrize("k,s,p,d,co", [c if len(c) == 5 else c + (40,)
                                        for c in CONVS],
                         ids=[f"{c[0]}x{c[0]}-s{c[1]}-d{c[3]}"
                              + (f"-co{c[4]}" if len(c) > 4 else "")
                              for c in CONVS])
@pytest.mark.parametrize("amax_scale", [1.0, 0.25, 0.0])
def test_int8_conv_matches_jax(k, s, p, d, co, amax_scale):
    rng = _rng(2)
    x = rng.normal(size=(2, 13, 17, 24)).astype(np.float32)
    w = rng.normal(size=(co, 24, k, k)).astype(np.float32)
    amax = np.float32(np.abs(x).max() * amax_scale)
    w_q, w_s = quant.quantize_weight(torch.from_numpy(w))
    got = quant.int8_conv(torch.from_numpy(x).permute(0, 3, 1, 2), w_q, w_s,
                          torch.tensor(amax), s, p, d)
    jw = jnp.asarray(w.transpose(2, 3, 1, 0))
    jw_q, jw_s = jax.jit(jax_quant.quantize_weight)(jw)
    xq, sx = jax.jit(jax_quant.quantize_act)(jnp.asarray(x),
                                             jnp.float32(amax))
    sums = jax.lax.conv_general_dilated(
        xq, jw_q, (s, s), ((p, p), (p, p)), rhs_dilation=(d, d),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    want = np.asarray(sums).astype(np.float32) * (np.asarray(sx)
                                                  * np.asarray(jw_s))
    got = got.permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
    compiled = jax.jit(lambda x, w, a: jax_quant.int8_conv(
        x, *jax_quant.quantize_weight(w), a, (s, s), ((p, p), (p, p)),
        (d, d)))(jnp.asarray(x), jw, jnp.float32(amax))
    np.testing.assert_allclose(got, np.asarray(compiled), rtol=2 ** -22,
                               atol=0)


def test_int8_dense_matches_jax():
    rng = _rng(3)
    x = rng.normal(size=(3, 5, 136)).astype(np.float32)
    w = rng.normal(size=(24, 136)).astype(np.float32)
    amax = np.float32(np.abs(x).max() * 0.5)
    w_q, w_s = quant.quantize_weight(torch.from_numpy(w))
    got = quant.int8_dense(torch.from_numpy(x), w_q, w_s, torch.tensor(amax))
    jw_q, jw_s = jax.jit(jax_quant.quantize_weight)(jnp.asarray(w.T))
    xq, sx = jax.jit(jax_quant.quantize_act)(jnp.asarray(x),
                                             jnp.float32(amax))
    sums = np.asarray(xq).astype(np.int64) @ np.asarray(jw_q).astype(
        np.int64)
    want = sums.astype(np.float32) * (np.asarray(sx) * np.asarray(jw_s))
    assert got.shape == (3, 5, 24)
    np.testing.assert_array_equal(got.numpy(), want)
    compiled = jax.jit(lambda x, w, a: jax_quant.int8_dense(
        x, *jax_quant.quantize_weight(w), a))(
            jnp.asarray(x), jnp.asarray(w.T), jnp.float32(amax))
    np.testing.assert_allclose(got.numpy(), np.asarray(compiled),
                               rtol=2 ** -22, atol=0)


@pytest.mark.parametrize("shape", [(7, 136), (2, 3, 5, 136),
                                   (4, 6, 136)],
                         ids=["2d", "4d-nhwc-view", "3d-strided"])
def test_int8_dense_shapes_match_jax(shape):
    """``int8_dense`` (kernels Q and I as a one-tap conv over the rows) on
    2-D, 4-D (a channels-last view of an NCHW map, as MiT's layers get
    it) and 3-D strided (a transposed view) inputs, Co = 21 (no multiple
    of 8), bit for bit against the JAX arithmetic on the JAX scales."""
    rng = _rng(13)
    x = rng.normal(size=shape).astype(np.float32)
    w = rng.normal(size=(21, 136)).astype(np.float32)
    amax = np.float32(np.abs(x).max() * 0.5)
    xt = torch.from_numpy(x)
    if len(shape) == 4:
        xt = xt.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    elif len(shape) == 3:
        xt = xt.transpose(0, 1).contiguous().transpose(0, 1)
    assert torch.equal(xt, torch.from_numpy(x))
    w_q, w_s = quant.quantize_weight(torch.from_numpy(w))
    copies = quant.layout_copies
    got = quant.int8_dense(xt, w_q, w_s, torch.tensor(amax))
    assert quant.layout_copies == copies
    jw_q, jw_s = jax.jit(jax_quant.quantize_weight)(jnp.asarray(w.T))
    xq, sx = jax.jit(jax_quant.quantize_act)(jnp.asarray(x),
                                             jnp.float32(amax))
    sums = np.asarray(xq).astype(np.int64) @ np.asarray(jw_q).astype(
        np.int64)
    want = sums.astype(np.float32) * (np.asarray(sx) * np.asarray(jw_s))
    assert got.shape == shape[:-1] + (21,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_bf16_output_is_the_rounded_float32():
    """The int8 path writes bf16 as the float32 result rounded once."""
    rng = _rng(4)
    x = torch.from_numpy(rng.normal(size=(1, 16, 9, 11)).astype(np.float32))
    w_q, w_s = quant.quantize_weight(torch.randn(32, 16, 3, 3))
    amax = x.abs().max()
    f32 = quant.int8_conv(x, w_q, w_s, amax, 1, 1, 1)
    bf16 = quant.int8_conv(x, w_q, w_s, amax, 1, 1, 1,
                           out_dtype=torch.bfloat16)
    assert torch.equal(bf16, f32.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# The quantised models
# ---------------------------------------------------------------------------

# (MODEL.NAME, MODEL.HYPER, MODEL.HFR)
MODELS = [("deeplabv3plus_resnettiny", True, True),
          ("segformer_mittiny", True, False)]
MODEL_IDS = [m[0] for m in MODELS]


def _configure(cfg, name, hyper, hfr, quant_eval):
    cfg.MODEL.NAME = name
    cfg.MODEL.HYPER = hyper
    cfg.MODEL.HFR = hfr
    cfg.MODEL.REDUCED_CHANNELS = 16
    cfg.MODEL.WEIGHTS = ""
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.QUANT_EVAL = quant_eval
    return cfg


@functools.lru_cache(maxsize=None)
def _jax_model(name, hyper, hfr, seed=3):
    """The JAX int8 build and its float32 variables (uncalibrated; shared
    by the tests, which must not change them)."""
    jmodel = jax_build_segmentor(_configure(jax_default_cfg(), name, hyper,
                                            hfr, True))
    variables = jax.jit(lambda rngs, x: jmodel.init(rngs, x, train=False))(
        {"params": jax.random.PRNGKey(seed),
         "dropout": jax.random.PRNGKey(seed + 1)},
        jnp.zeros((1, 64, 64, 3), jnp.float32))
    return jmodel, jax.tree_util.tree_map(
        lambda v: v if v.dtype == jnp.int8 else jnp.asarray(v, jnp.float32),
        dict(variables))


def _port_model(name, hyper, hfr, variables=None, quant_eval=True):
    model = build_segmentor(_configure(get_default_cfg(), name, hyper, hfr,
                                       quant_eval), device="cpu")
    if variables is not None:
        model.load_state_dict(variables_to_state_dict(
            jax.tree_util.tree_map(np.asarray, variables)), strict=True)
    return model.eval()


def _names(model):
    return {name for name, _ in quant.quant_layers(model)}


@pytest.mark.parametrize("name,hyper,hfr", MODELS, ids=MODEL_IDS)
def test_quantised_layers_match_jax(name, hyper, hfr):
    """The int8 build quantises the JAX build's layers: its ``quant``
    collection's layers, mapped to the port's names, are the port's
    QuantConv/QuantDense layers; their float layers (the stem, the
    depthwise convs, the narrow dense layers, the heads' producers) have
    no quantisation state on either side."""
    _, variables = _jax_model(name, hyper, hfr)
    want = set(quant_tree_to_state(jax.tree_util.tree_map(
        np.asarray, variables["quant"])))
    model = _port_model(name, hyper, hfr)
    assert _names(model) == want
    if name == "segformer_mittiny":
        # stage 1 (16 ch) and stage-2 attention (32 ch) stay float; the
        # fc2 of stage 3 (hidden 256) and stage 4's layers quantise
        assert "feature_extractor.backbone.block1.0.mlp.fc2" not in want
        assert "feature_extractor.backbone.block3.0.mlp.fc2" in want
        assert "feature_extractor.backbone.block4.0.attn.kv" in want
        assert "classifier.fuse_conv" in want
        assert not any("patch_embed" in n for n in want)   # Cin < 128
    else:
        assert "classifier.bottleneck.0" in want
        assert "classifier.decoder.1.pointwise_conv" in want
        assert not any("depthwise" in n or "conv_reduce" in n
                       for n in want)
        assert "feature_extractor.backbone.conv1" not in want


def test_strided_rules_match_jax():
    """Static: a strided conv quantises only on an input of >= 128
    channels. Per call: below 2048 output positions a strided QuantConv
    is the float conv bit for bit (here and in the JAX package); at or
    above, both run int8."""
    assert layers.quant_eligible(True, 1)
    assert not layers.quant_eligible(True, 2)
    assert not layers.quant_eligible(True, 2, in_features=64)
    assert layers.quant_eligible(True, 2, in_features=128)
    assert not layers.quant_eligible(True, 2, groups=2, in_features=256)
    assert not layers.quant_eligible(False, 1)
    assert isinstance(layers.make_conv(128, 8, 3, 2, 1, quant=True),
                      layers.QuantConv)
    assert type(layers.make_conv(64, 8, 3, 2, 1, quant=True)) is \
        torch.nn.Conv2d
    assert type(layers.make_dense(64, 8, quant=True)) is torch.nn.Linear
    assert isinstance(layers.make_dense(128, 8, quant=True),
                      layers.QuantDense)
    jax_layers.QUANT_EVAL = True
    rng = _rng(5)
    w = rng.normal(size=(8, 128, 3, 3)).astype(np.float32) * 0.05
    for hw, int8 in ((32, False), (96, True)):    # 16x16 / 48x48 outputs
        x = rng.normal(size=(1, hw, hw, 128)).astype(np.float32)
        conv = layers.QuantConv(128, 8, 3, stride=2, padding=1,
                                bias=False).eval()
        conv.weight.data = torch.from_numpy(w)
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        quant.calibrate(conv, [xt])
        got = conv(xt)
        jmod = jax_layers.QuantConv(8, (3, 3), strides=(2, 2),
                                    padding=((1, 1), (1, 1)), train=False)
        v = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
        v = {**v, "params": {"kernel": jnp.asarray(w.transpose(2, 3, 1, 0))}}
        mut = jax.jit(lambda v, x: jmod.apply(v, x, mutable=["quant"])[1])(
            v, jnp.asarray(x))
        want = jax.jit(jmod.apply)({**v, "quant": mut["quant"]},
                                   jnp.asarray(x))
        got = got.permute(0, 2, 3, 1).detach().numpy()
        if int8:   # one ulp: XLA reassociates the scales' product
            np.testing.assert_allclose(got, np.asarray(want), rtol=2 ** -22,
                                       atol=0)
        else:   # both float convs: summation order only
            np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                       atol=1e-5 * np.abs(want).max())
        with torch.no_grad():
            flt = F.conv2d(xt, conv.weight, None, 2, 1)
        assert np.array_equal(got, flt.permute(0, 2, 3, 1).numpy()) != int8


@pytest.mark.parametrize("name,hyper,hfr", MODELS[:2], ids=MODEL_IDS[:2])
def test_int8_build_is_the_float_build_in_train_mode(name, hyper, hfr):
    """Same parameter names and seeded init as the float build, the int8
    state outside ``state_dict``, and the train-mode forward bit for bit
    the float build's (dropout from the same seed)."""
    gen = 11
    qcfg = _configure(get_default_cfg(), name, hyper, hfr, True)
    fcfg = _configure(get_default_cfg(), name, hyper, hfr, False)
    qmodel = build_segmentor(qcfg, device="cpu",
                             generator=torch.Generator().manual_seed(gen))
    fmodel = build_segmentor(fcfg, device="cpu",
                             generator=torch.Generator().manual_seed(gen))
    sq, sf = qmodel.state_dict(), fmodel.state_dict()
    assert sq.keys() == sf.keys()
    assert all(torch.equal(sq[k], sf[k]) for k in sq)
    assert _names(qmodel) and not _names(fmodel)
    x = torch.from_numpy(_rng(6).normal(size=(2, 3, 64, 64))
                         .astype(np.float32))
    outs = []
    for model in (qmodel, fmodel):
        model.train()
        torch.manual_seed(0)
        outs.append(model(x))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def _jax_calibrate(jmodel, variables, x):
    jax_layers.QUANT_EVAL = True
    return jax_quant.calibrate(jmodel, variables, [jnp.asarray(x)])


@pytest.mark.parametrize("name,hyper,hfr", MODELS[:2], ids=MODEL_IDS[:2])
def test_calibrate_matches_jax(name, hyper, hfr):
    jmodel, variables = _jax_model(name, hyper, hfr)
    model = _port_model(name, hyper, hfr, variables)
    x = _rng(7).normal(size=(1, 64, 64, 3)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with pytest.raises(ValueError, match="uncalibrated"):
        quant.assert_calibrated(model)
    with pytest.raises(ValueError, match="at least one batch"):
        quant.calibrate(model, [])
    with pytest.raises(ValueError, match="no quantized layers"):
        quant.assert_calibrated(_port_model(name, hyper, hfr,
                                            quant_eval=False))
    # recalibration replaces: an inflating pass on 2x, then x again
    quant.calibrate(model, [2 * xt])
    quant.calibrate(model, [xt])
    quant.assert_calibrated(model)
    assert not model.training
    want = quant_tree_to_state(jax.tree_util.tree_map(
        np.asarray, _jax_calibrate(jmodel, variables, x)["quant"]))
    got = quant.quant_state(model)
    assert got.keys() == want.keys()
    for layer in got:
        np.testing.assert_array_equal(got[layer]["w_int8"],
                                      want[layer]["w_int8"], err_msg=layer)
        np.testing.assert_array_equal(got[layer]["w_scale"],
                                      want[layer]["w_scale"], err_msg=layer)
        np.testing.assert_allclose(got[layer]["amax"], want[layer]["amax"],
                                   rtol=4e-6, err_msg=layer)
    # reset=False keeps a running max across calls
    quant.calibrate(model, [0.5 * xt])
    half = {k: float(v["amax"]) for k, v in quant.quant_state(model).items()}
    quant.calibrate(model, [xt])
    quant.calibrate(model, [0.5 * xt], reset=False)
    assert {k: float(v["amax"]) for k, v in quant.quant_state(
        model).items()} == {k: max(half[k], float(got[k]["amax"]))
                            for k in got}


def _capture_jax(jmodel, variables, x, mit):
    """The JAX int8 forward's logits (compiled, as the JAX package runs
    it) and each quantised layer's input, by port layer name."""
    quant_paths = set(quant_tree_to_state(jax.tree_util.tree_map(
        np.asarray, variables["quant"])))

    def run(v, x):
        inputs = {}

        def interceptor(next_fun, args, kwargs, context):
            mod = context.module
            if (context.method_name == "__call__"
                    and isinstance(mod, (jax_layers.QuantConv,
                                         jax_layers.QuantDense))):
                name = _layer_name(mod.path[0], tuple(mod.path[1:]), mit)
                if name in quant_paths:
                    inputs[name] = args[0]
            return next_fun(*args, **kwargs)

        with fnn.intercept_methods(interceptor):
            out, _ = jmodel.apply(v, x, train=False)
        return out, inputs

    jax_layers.QUANT_EVAL = True
    out, inputs = jax.jit(run)(variables, jnp.asarray(x))
    return np.asarray(out), {k: np.asarray(v) for k, v in inputs.items()}


def _capture_port(model, x):
    """The port's logits and each quantised layer's input, channel-last (a
    QuantConv's as it convolves it: its sources concatenated, the pending
    norm and ReLU applied)."""
    inputs = {}

    def keep(name, conv):
        def hook(_mod, args):
            if conv:
                t = layers.QuantConv.input_of(*args).detach()
                inputs[name] = t.permute(0, 2, 3, 1)
            else:
                inputs[name] = args[0].detach()
        return hook

    hooks = [mod.register_forward_pre_hook(
        keep(name, isinstance(mod, layers.QuantConv)))
        for name, mod in quant.quant_layers(model)]
    try:
        with torch.no_grad():
            out, _ = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    finally:
        for h in hooks:
            h.remove()
    return out.numpy(), inputs


@pytest.mark.parametrize("name,hyper,hfr", MODELS, ids=MODEL_IDS)
def test_quantised_forward_matches_jax(name, hyper, hfr):
    """The JAX calibration carried across (``quant_tree_to_state``), the
    int8 forwards at 96x96. Every int8 activation that differs from the
    JAX package's is reported with the float inputs x/sx of both sides;
    in forward order, the first layer that has any has them only where
    the input sits on a rounding boundary (x/sx within 1e-3 of a half
    integer: float32 summation order upstream puts it on either side);
    later layers may differ where such a flip reached their input; every
    difference is one int8 step. Logits: within 1e-4 of their max when no
    activation differs, else within 1e-2 (one int8 step is 1/127 of a
    layer's range, and a flipped activation moves the logits by about
    that), and the same argmax on >= 99% of the pixels."""
    jmodel, variables = _jax_model(name, hyper, hfr)
    x = _rng(8).normal(size=(1, 96, 96, 3)).astype(np.float32)
    variables = _jax_calibrate(jmodel, variables, x)
    model = _port_model(name, hyper, hfr, variables)
    state = quant_tree_to_state(jax.tree_util.tree_map(np.asarray,
                                                       variables["quant"]))
    assert quant.load_quant_state(model, state)
    want, jin = _capture_jax(jmodel, variables, x, name.startswith("seg"))
    got, pin = _capture_port(model, x)
    assert jin.keys() == pin.keys() == state.keys()
    differing, first = 0, None
    for layer, xp in pin.items():     # forward order
        amax = state[layer]["amax"]
        qp, sx = quant.quantize_act(xp, amax)
        qj = np.asarray(jax.jit(jax_quant.quantize_act)(
            jnp.asarray(jin[layer]), jnp.float32(amax))[0])
        bad = np.argwhere(qp.numpy() != qj)
        if len(bad) and first is None:
            first = layer
        for idx in map(tuple, bad):
            ratio = float(xp[idx] / sx)
            print(f"{layer}{[int(i) for i in idx]}: int8 {int(qp[idx])} "
                  f"(port) vs {int(qj[idx])} (JAX); x/sx {ratio:.6f} (port) "
                  f"{float(jin[layer][idx] / sx.numpy()):.6f} (JAX)")
            assert abs(int(qp[idx]) - int(qj[idx])) == 1
            if layer == first:
                assert abs(abs(ratio - np.floor(ratio)) - 0.5) < 1e-3, (
                    f"{layer}{list(idx)} differs off a rounding boundary")
        differing += len(bad)
    print(f"{name}: {differing} int8 activations differ over {len(pin)} "
          f"layers; first in {first}")
    assert np.isfinite(got).all() and got.shape == want.shape
    atol = 1e-4 if differing == 0 else 1e-2
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=atol * np.abs(want).max())
    assert np.mean(got.argmax(-1) == want.argmax(-1)) >= 0.99


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _jax_checkpoint(path, name="deeplabv3plus_resnettiny", calibrated=True,
                    drop=None):
    """A JAX msgpack checkpoint of the int8 build (calibrated on a seeded
    batch), optionally with one quantised layer dropped from its
    ``quant`` tree."""
    jmodel, variables = _jax_model(name, True, True)
    variables = dict(variables)
    x = _rng(9).normal(size=(1, 64, 64, 3)).astype(np.float32)
    if calibrated:
        variables = _jax_calibrate(jmodel, variables, x)
    if drop:
        fe = dict(variables["quant"]["feature_extractor"])
        fe.pop(drop)
        variables["quant"] = {**variables["quant"],
                              "feature_extractor": fe}
    jcfg = _configure(jax_default_cfg(), name, True, True, True)
    tx = jax_build_optimizer(jcfg, 1)[0]
    jax_state.save_checkpoint(jax_state.state_from_variables(variables, tx),
                              str(path))
    return variables


def test_jax_checkpoint_resumes_calibrated(tmp_path):
    path = tmp_path / "jax.ckpt"
    variables = _jax_checkpoint(path)
    model = _port_model("deeplabv3plus_resnettiny", True, True)
    for module in ("feature_extractor", "classifier"):
        assert load_module_params(model, str(path), module)
    quant.assert_calibrated(model)
    want = quant_tree_to_state(jax.tree_util.tree_map(np.asarray,
                                                      variables["quant"]))
    got = quant.quant_state(model)
    assert got.keys() == want.keys()
    for layer in got:
        for key in ("amax", "w_int8", "w_scale"):
            assert torch.equal(got[layer][key], want[layer][key])
    # the whole-run restore takes it too
    fresh = _port_model("deeplabv3plus_resnettiny", True, True)
    cfg = _configure(get_default_cfg(), "deeplabv3plus_resnettiny", True,
                     True, True)
    cfg.SOLVER.MOMENTUM = 0.0
    opt, sched, _ = build_optimizer(cfg, fresh)
    restore_state(fresh, opt, sched, str(path))
    quant.assert_calibrated(fresh)


def test_port_checkpoint_round_trip_keeps_calibration(tmp_path):
    name = "segformer_mittiny"
    model = _port_model(name, True, False)
    x = torch.from_numpy(_rng(10).normal(size=(1, 3, 64, 64))
                         .astype(np.float32))
    quant.calibrate(model, [x])
    cfg = _configure(get_default_cfg(), name, True, False, True)
    opt, sched, _ = build_optimizer(cfg, model)
    path = str(tmp_path / "port.ckpt")
    save_checkpoint(model, path, optimizer=opt, step=3)
    want = quant.quant_state(model)
    for restore in ("modules", "full"):
        fresh = _port_model(name, True, False)
        if restore == "modules":
            for module in ("feature_extractor", "classifier"):
                load_module_params(fresh, path, module)
        else:
            opt2, sched2, _ = build_optimizer(cfg, fresh)
            assert restore_state(fresh, opt2, sched2, path)["step"] == 3
        got = quant.quant_state(fresh)
        assert got.keys() == want.keys()
        assert all(torch.equal(got[n][k], want[n][k])
                   for n in got for k in want[n])
    with torch.no_grad():
        a = model(x)[0]
        b = fresh(x)[0]
    assert torch.equal(a, b)
    # a float build loads the same file and ignores its calibration
    flt = _port_model(name, True, False, quant_eval=False)
    for module in ("feature_extractor", "classifier"):
        assert load_module_params(flt, path, module)
    assert not quant.quant_layers(flt)


def test_drifted_calibration_warns_and_is_dropped(tmp_path):
    """A calibration of another layer set (one trunk layer missing, as
    when the eligibility rule changed) warns and is dropped for its
    module, which stays uncalibrated; the parameters load all the same."""
    path = tmp_path / "drift.ckpt"
    variables = _jax_checkpoint(path, drop="layer1_0")
    model = _port_model("deeplabv3plus_resnettiny", True, True)
    with pytest.warns(UserWarning, match="quant state"):
        load_module_params(model, str(path), "feature_extractor")
    load_module_params(model, str(path), "classifier")
    with pytest.raises(ValueError, match="uncalibrated quantized layer at "
                       "feature_extractor"):
        quant.assert_calibrated(model)
    assert all(float(m.amax) > 0 for _, m in
               quant.quant_layers(model.classifier))
    want = variables_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                          variables))
    got = model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
