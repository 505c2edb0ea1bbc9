"""Port parity, SegFormer/MiT: each module of ``models/segformer.py``, the
whole MiT trunk and the ``*_mittiny`` segmentors against the JAX package
from the same weights (the JAX init carried across by
``models.convert``), float32 compute, eval mode, at 64x64 and at a size
no stage divides evenly (72x88: the ``sr`` convs pad as flax pads
``SAME``); every MiT arch under every head; an upstream NVlabs MiT file
read by both packages' ``MODEL.WEIGHTS``; a JAX msgpack checkpoint of
``segformer_mittiny`` restored in the port.

Tolerances: modules and stage maps atol 1e-5; segmentor logits atol 1e-4
and the embedding (or the Euclidean decoder features, within 1e-5 of
their max where that exceeds 1) 1e-5, argmax agreement >= 99.9%, as in
tests/test_torch_models.py; momentum buffers within 1e-6 of their max
(float32 through a layout change only); ``TPU.REMAT`` changes nothing bit
for bit.
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

from halo_tpu.config import get_default_cfg as jax_default_cfg
from halo_tpu.engine import state as jax_state
from halo_tpu.engine.optim import build_optimizer as jax_build_optimizer
from halo_tpu.engine.steps import make_train_step as jax_make_train_step
from halo_tpu.models import layers as jax_layers
from halo_tpu.models import segformer as jax_sf
from halo_tpu.models.build import build_segmentor as jax_build_segmentor
from halo_tpu.models.port_torch import \
    load_pretrained_backbone as jax_load_pretrained
from halo_tpu.models.port_torch import torch_state_dict_to_variables
from halo_tpu_torch.config import get_default_cfg
from halo_tpu_torch.engine import make_forward
from halo_tpu_torch.engine.optim import build_optimizer
from halo_tpu_torch.engine.state import restore_state
from halo_tpu_torch.engine.steps import make_train_step
from halo_tpu_torch.models import build_segmentor, variables_to_state_dict
from halo_tpu_torch.models import segformer
from halo_tpu_torch.models.pretrained import load_pretrained_backbone
from tests.test_torch_families import _hold
from tests.test_torch_train import _batches, _momentum

SIZES = [(64, 64), (72, 88)]
TINY = jax_sf.MIT_ARCHS["mittiny"]


@pytest.fixture
def tmp_path():
    """A directory removed when the test ends, in place of pytest's kept
    one."""
    with tempfile.TemporaryDirectory() as d:
        yield pathlib.Path(d)


@pytest.fixture(autouse=True)
def jax_globals(monkeypatch):
    for name in ("DENSE_CONV_MODE", "STENCIL_TRAIN", "CONV_WGRAD",
                 "QUANT_EVAL"):
        monkeypatch.setattr(jax_layers, name, getattr(jax_layers, name))


def _f32(a):
    return np.asarray(a, np.float32)


@functools.lru_cache(maxsize=None)
def _tiny_trunks(seed=0):
    """The JAX mittiny trunk's params (float32 numpy) and the port's
    trunk (eval mode) loaded from them through
    ``variables_to_state_dict``."""
    jmodel = jax_sf.MixVisionTransformer(**TINY)
    params = jmodel.init(jax.random.PRNGKey(seed),
                         jnp.zeros((1, 64, 64, 3), jnp.float32),
                         train=False)["params"]
    params = jax.tree_util.tree_map(_f32, params)
    sd = variables_to_state_dict({"params": {"feature_extractor": params}})
    trunk = segformer.mit_feature_extractor("mittiny")
    prefix = "feature_extractor."
    trunk.load_state_dict({k[len(prefix):]: v for k, v in sd.items()},
                          strict=True)
    return jmodel, params, trunk.eval()


# (name, JAX module, its params' path, the port module's path, the
# input's trailing shape at each of SIZES)
MODULES = [
    ("patch_embed1_7x7s4", jax_sf.OverlapPatchEmbed(16, 7, 4, train=False),
     ("patch_embed1",), "patch_embed1", [(64, 64, 3), (72, 88, 3)]),
    ("patch_embed2_3x3s2", jax_sf.OverlapPatchEmbed(32, 3, 2, train=False),
     ("patch_embed2",), "patch_embed2", [(16, 16, 16), (18, 22, 16)]),
    ("attention_sr8", jax_sf.EfficientAttention(16, 1, 8, train=False),
     ("block1_0", "attn"), "block1.0.attn", [(16, 16, 16), (18, 22, 16)]),
    ("attention_sr1", jax_sf.EfficientAttention(128, 8, 1, train=False),
     ("block4_0", "attn"), "block4.0.attn", [(4, 4, 128), (5, 7, 128)]),
    ("mixffn", jax_sf.MixFFN(32, train=False), ("block2_0", "ffn"),
     "block2.0.mlp", [(8, 8, 32), (9, 11, 32)]),
    ("block", jax_sf.MiTBlock(16, 1, 8, train=False), ("block1_0",),
     "block1.0", [(16, 16, 16), (18, 22, 16)]),
]


@pytest.mark.parametrize("name,jmod,path,port_path,shapes", MODULES,
                         ids=[m[0] for m in MODULES])
def test_module_matches_jax(name, jmod, path, port_path, shapes):
    _, params, trunk = _tiny_trunks()
    sub = params
    for p in path:
        sub = sub[p]
    mod = trunk.backbone.get_submodule(port_path)
    for i, shape in enumerate(shapes):
        x = np.random.default_rng(i).normal(size=(2,) + shape).astype(
            np.float32)
        want = np.asarray(jmod.apply({"params": sub}, jnp.asarray(x)))
        xt = torch.from_numpy(x)
        if name.startswith("patch_embed"):
            xt = xt.permute(0, 3, 1, 2)   # an image or a stage map, NCHW
        with torch.no_grad():
            got = mod(xt).numpy()
        assert got.shape == want.shape, (shape, got.shape, want.shape)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5,
                                   err_msg=f"{name} at {shape}")


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_trunk_matches_jax(size):
    """All four stage maps and the head contract's aliases."""
    jmodel, params, trunk = _tiny_trunks(seed=1)
    x = np.random.default_rng(2).normal(size=(2,) + size + (3,)).astype(
        np.float32)
    want = jmodel.apply({"params": params}, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = trunk(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert set(got) == set(want) == {"c1", "c2", "c3", "c4", "low", "out"}
    for k in ("c1", "c2", "c3", "c4"):
        g = got[k].permute(0, 2, 3, 1).numpy()
        assert g.shape == want[k].shape
        np.testing.assert_allclose(g, np.asarray(want[k]), rtol=0,
                                   atol=1e-5, err_msg=k)
    assert got["low"] is got["c1"] and got["out"] is got["c4"]
    assert trunk.channels == {"c1": 16, "c2": 32, "c3": 64, "c4": 128,
                              "low": 16, "out": 128}


def _configure(cfg, name, hyper, hfr=False):
    cfg.MODEL.NAME = name
    cfg.MODEL.HYPER = hyper
    cfg.MODEL.REDUCED_CHANNELS = 16
    cfg.MODEL.HFR = hfr
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.MODEL.WEIGHTS = ""
    return cfg


# (MODEL.NAME, MODEL.HYPER, MODEL.HFR): HFR as each head's recipe has it
# (the ACDC recipe's SegFormer without, the DeepLab-v3+ recipes' with;
# the v2 head has none). Without HFR the random v3+ head puts its
# embedding at the ball's edge (norms 0.9995), where the MLR magnifies
# float32 rounding of a matching embedding (1e-6) to 3e-4 in its logits.
SEGMENTORS = [("segformer_mittiny", True, False),
              ("segformer_mittiny", False, False),
              ("deeplabv3plus_mittiny", True, True),
              ("deeplabv2_mittiny", True, False)]


@pytest.mark.parametrize("name,hyper,hfr", SEGMENTORS,
                         ids=[f"{n}-{'hyper' if h else 'euclid'}"
                              for n, h, _ in SEGMENTORS])
def test_segmentor_matches_jax(name, hyper, hfr):
    """The port's state_dict carries the JAX variables (the JAX importer
    reads its trunk back bit for bit) and the forwards match at both
    sizes."""
    jmodel = jax_build_segmentor(_configure(jax_default_cfg(), name, hyper,
                                            hfr))
    variables = jmodel.init(
        {"params": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)},
        jnp.zeros((1, 64, 64, 3), jnp.float32), train=False)
    variables = jax.tree_util.tree_map(_f32, dict(variables))
    sd = variables_to_state_dict(variables)
    model = build_segmentor(_configure(get_default_cfg(), name, hyper, hfr),
                            device="cpu")
    model.load_state_dict(sd, strict=True)
    back = torch_state_dict_to_variables(
        {k: v.numpy() for k, v in sd.items()}, "feature_extractor")
    want_tree = dict(jax.tree_util.tree_leaves_with_path(
        variables["params"]["feature_extractor"]))
    got_tree = dict(jax.tree_util.tree_leaves_with_path(back["params"]))
    assert got_tree.keys() == want_tree.keys()
    for path, leaf in want_tree.items():
        np.testing.assert_array_equal(got_tree[path], leaf)

    forward = make_forward(model)
    for i, size in enumerate(SIZES):
        x = np.random.default_rng(5 + i).normal(size=(2,) + size + (3,))
        x = x.astype(np.float32)
        want = jax.jit(lambda v, x: jmodel.apply(v, x, size=size,
                                                 train=False))(
            variables, jnp.asarray(x))
        with torch.no_grad():
            got = forward(torch.from_numpy(x))
        _hold(got, want)
        if name.startswith("segformer"):
            # the embedding / features at c1's resolution (stride 4)
            assert got[1].shape[1:3] == (-(-size[0] // 4), -(-size[1] // 4))


def test_every_arch_under_every_head():
    """Every MIT_ARCHS trunk builds under the SegFormer and both DeepLab
    heads, Euclidean and hyperbolic; the segformer-hyper model's names and
    shapes are those of the JAX model's variables, converted."""
    assert segformer.MIT_ARCHS == jax_sf.MIT_ARCHS
    for arch in segformer.MIT_ARCHS:
        jcfg = _configure(jax_default_cfg(), f"segformer_{arch}", True)
        jmodel = jax_build_segmentor(jcfg)
        shapes = jax.eval_shape(lambda x: jmodel.init(
            {"params": jax.random.PRNGKey(0),
             "dropout": jax.random.PRNGKey(1)}, x, train=False),
            jnp.zeros((1, 64, 64, 3), jnp.float32))
        want = {k: tuple(v.shape) for k, v in variables_to_state_dict(
            jax.tree_util.tree_map(
                lambda s: np.broadcast_to(np.float32(0), s.shape),
                dict(shapes))).items()}
        for head in ("segformer", "deeplabv2", "deeplabv3plus"):
            for hyper in (False, True):
                cfg = _configure(get_default_cfg(), f"{head}_{arch}", hyper)
                with torch.device("meta"):
                    model = build_segmentor(cfg, device="meta")
                got = {k: tuple(v.shape)
                       for k, v in model.state_dict().items()}
                if (head, hyper) == ("segformer", True):
                    assert got == want, arch
                n_blocks = sum(jax_sf.MIT_ARCHS[arch]["depths"])
                assert sum(k.endswith("attn.kv.weight")
                           for k in got) == n_blocks


def _upstream_mit_file(path, seed=0):
    """A seeded NVlabs-layout mittiny ``state_dict`` under a ``backbone.``
    prefix, with the ImageNet ``head``, at ``path``; returns the trunk's
    tensors by their unprefixed names."""
    with torch.device("meta"):
        keys = segformer.MixVisionTransformer(**TINY).state_dict()
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in keys.items():
        shape = tuple(v.shape)
        if k.endswith("norm1.weight") or k.endswith("norm2.weight") or (
                "norm" in k and k.endswith("weight")):
            sd[k] = torch.rand(shape, generator=gen) + 0.5
        elif len(shape) >= 2:
            fan_in = int(np.prod(shape[1:]))
            sd[k] = torch.randn(shape, generator=gen) / np.sqrt(fan_in)
        else:
            sd[k] = torch.randn(shape, generator=gen) * 0.1
    blob = {"backbone." + k: v for k, v in sd.items()}
    blob["head.weight"] = torch.zeros(1000, 128)
    blob["head.bias"] = torch.zeros(1000)
    torch.save(blob, path)
    return sd


def test_upstream_mit_weights_load_in_both(tmp_path):
    """``MODEL.WEIGHTS`` in the upstream layout: the port's trunk equals
    the file, and the JAX package's importer (the oracle of the name
    mapping, fused ``kv`` split) gives a trunk with the same outputs."""
    path = str(tmp_path / "mit_tiny.pth")
    sd = _upstream_mit_file(path)
    cfg = _configure(get_default_cfg(), "segformer_mittiny", True)
    model = build_segmentor(cfg, device="cpu")
    assert load_pretrained_backbone(model, path) == path
    trunk = model.feature_extractor.backbone.state_dict()
    assert trunk.keys() == sd.keys()
    for k, v in trunk.items():
        assert torch.equal(v, sd[k]), k

    jcfg = _configure(jax_default_cfg(), "segformer_mittiny", True)
    jmodel = jax_build_segmentor(jcfg)
    variables = jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, 64, 64, 3), jnp.float32), train=False)
    variables = jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float32),
                                       variables)
    state = jax_state.state_from_variables(
        variables, jax_build_optimizer(jcfg, 1)[0])
    state = jax_load_pretrained(state, path)
    x = np.random.default_rng(1).normal(size=(2, 72, 88, 3)).astype(
        np.float32)
    want = jax_sf.MixVisionTransformer(**TINY).apply(
        {"params": state.params["feature_extractor"]}, jnp.asarray(x),
        train=False)
    with torch.no_grad():
        got = model.feature_extractor(torch.from_numpy(x).permute(0, 3, 1, 2))
    for k in ("c1", "c2", "c3", "c4"):
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].permute(0, 2, 3, 1).numpy(), w,
                                   rtol=0, atol=1e-5 * max(1.0,
                                                           np.abs(w).max()),
                                   err_msg=k)
    # a file without one of the trunk's tensors is refused
    blob = torch.load(path, weights_only=True)
    del blob["backbone.block2.0.attn.kv.bias"]
    torch.save(blob, path)
    with pytest.raises(RuntimeError, match="does not fit the trunk"):
        load_pretrained_backbone(model, path)


def test_jax_checkpoint_restores(tmp_path, monkeypatch):
    """A JAX msgpack checkpoint of segformer_mittiny after one
    source_target step: the port's parameters and the live ``fuse_bn``
    statistics equal the JAX state's, the SGD momentum buffers carry over
    (``k``/``v`` fused into ``kv``), the forwards agree, and the next
    step's loss terms match the JAX step's."""
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, inputs, *a, **k: inputs)
    jcfg = _configure(jax_default_cfg(), "segformer_mittiny", True)
    jcfg.SOLVER.WARMUP_ITERS = 0
    jcfg.SOLVER.NUM_ITER = 4
    jcfg.SOLVER.NEGATIVE_THRESHOLD = 0.2
    jmodel = jax_build_segmentor(jcfg)
    variables = jmodel.init(
        {"params": jax.random.PRNGKey(6), "dropout": jax.random.PRNGKey(7)},
        jnp.zeros((1, 64, 64, 3), jnp.float32), train=False)
    variables = jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float32),
                                       variables)
    tx, _ = jax_build_optimizer(jcfg, 1)
    state = jax_state.state_from_variables(variables, tx)
    jstep = jax.jit(jax_make_train_step(jcfg, jmodel, tx, "source_target"))
    state, _ = jstep(state, jax.tree_util.tree_map(jnp.asarray,
                                                   _batches(30, 32)),
                     jax.random.PRNGKey(0))
    path = str(tmp_path / "last.ckpt")
    jax_state.save_checkpoint(state, path)

    cfg = _configure(get_default_cfg(), "segformer_mittiny", True)
    cfg.merge_from_other_cfg(jcfg)
    model = build_segmentor(cfg, device="cpu")
    model.classifier.dropout.p = 0.0
    model.train()
    optimizer, scheduler, _ = build_optimizer(cfg, model)
    assert restore_state(model, optimizer, scheduler, path)["step"] == 1
    stats = state.batch_stats["classifier"]["fuse_bn"]
    bn = model.classifier.fuse_bn
    np.testing.assert_array_equal(bn.running_mean.numpy(),
                                  np.asarray(stats["mean"]))
    np.testing.assert_array_equal(bn.running_var.numpy(),
                                  np.asarray(stats["var"]))
    trace = {k: v for k, v in variables_to_state_dict(
        {"params": _momentum(state)}).items()
        if not k.endswith("num_batches_tracked")}
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(trace)
    for n, param in model.named_parameters():
        want = trace[n].numpy()
        got = optimizer.state[param]["momentum_buffer"].numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max(), err_msg=n)

    # the restored model is the JAX state's, bit for bit; so is its
    # forward up to float32 rounding: the embedding within 1e-5 (after a
    # step it sits at the ball's edge, where the MLR magnifies that
    # rounding in the logits, so those are held by their argmax here and
    # at 1e-4 in test_segmentor_matches_jax)
    own = model.state_dict()
    for k, v in variables_to_state_dict(jax.tree_util.tree_map(
            np.asarray, state.variables())).items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(own[k], v), k
    x = np.random.default_rng(8).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    model.eval()
    logits, embed = jax.jit(lambda v, x: jmodel.apply(
        v, x, size=(64, 64), train=False))(
        jax.tree_util.tree_map(jnp.asarray, state.variables()),
        jnp.asarray(x))
    with torch.no_grad():
        t_logits, t_embed = make_forward(model)(torch.from_numpy(x))
    np.testing.assert_allclose(t_embed.numpy(), np.asarray(embed), rtol=0,
                               atol=1e-5)
    assert (t_logits.numpy().argmax(-1)
            == np.asarray(logits).argmax(-1)).mean() >= 0.999

    model.train()
    b = _batches(40, 32)
    state, jmetrics = jstep(state, jax.tree_util.tree_map(jnp.asarray, b),
                            jax.random.PRNGKey(1))
    metrics = make_train_step(cfg, model, optimizer, "source_target")(
        {k: {n: torch.from_numpy(v) for n, v in d.items()}
         for k, d in b.items()})
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5,
                                   err_msg=k)


def test_remat_changes_nothing():
    """``TPU.REMAT`` on a MiT: the same loss and gradients bit for bit."""
    grads = []
    x = torch.from_numpy(np.random.default_rng(9).normal(
        size=(2, 64, 64, 3)).astype(np.float32))
    for remat in (False, True):
        cfg = _configure(get_default_cfg(), "segformer_mittiny", True)
        cfg.TPU.REMAT = remat
        model = build_segmentor(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(2))
        model.classifier.dropout.p = 0.0
        model.train()
        logits, _ = make_forward(model)(x)
        logits.square().mean().backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
        grads[-1]["fuse_bn.running_mean"] = \
            model.classifier.fuse_bn.running_mean.clone()
    assert grads[0].keys() == grads[1].keys()
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k
