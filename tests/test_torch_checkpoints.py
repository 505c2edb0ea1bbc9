"""Port parity, weights from outside the port: ``MODEL.WEIGHTS`` (a
torchvision-layout trunk ``.pth``) loaded by both packages, and the JAX
package's msgpack checkpoints read by the port (``resume`` and
``resume_full``), resnettiny, float32.

Expected: the loaded trunk equals the file bit for bit, and its outputs
match the JAX trunk's within 1e-5 of their max; a missing file, a URL not
in the torch hub cache and a file that does not fit the trunk each raise.
From a JAX checkpoint (with a bfloat16 leaf, widened exactly) the port's
eval logits match the JAX model's within 1e-4 and its ball embedding
within 1e-5; ``restore_state`` carries the momentum buffers (within 1e-6
of their max: float32 through a layout change only), the step, the
learner counters and the LR, and the next step's loss terms match the
JAX step's within 1e-5 relative.
"""

import pathlib
import tempfile

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import chip_smoke
from halo_tpu.config import get_default_cfg as jax_default_cfg
from halo_tpu.engine import state as jax_state
from halo_tpu.engine.optim import build_optimizer as jax_build_optimizer
from halo_tpu.engine.steps import make_train_step as jax_make_train_step
from halo_tpu.models import layers as jax_layers
from halo_tpu.models import resnet as jax_resnet
from halo_tpu.models.build import build_segmentor as jax_build_segmentor
from halo_tpu.models.port_torch import \
    load_pretrained_backbone as jax_load_pretrained
from halo_tpu_torch.config import get_default_cfg
from halo_tpu_torch.engine import make_forward
from halo_tpu_torch.engine.learners import TestLearner
from halo_tpu_torch.engine.optim import build_optimizer
from halo_tpu_torch.engine.state import (is_jax_checkpoint,
                                         load_module_params, restore_state)
from halo_tpu_torch.engine.steps import make_train_step
from halo_tpu_torch.models import build_segmentor
from halo_tpu_torch.models.pretrained import (load_pretrained_backbone,
                                              resolve_pretrained_weights)
from halo_tpu_torch.utils.misc import parse_args
from tests.test_torch_eval import _argv
from tests.test_torch_train import _batches, _momentum, _state_dict64


@pytest.fixture
def tmp_path():
    """A directory removed when the test ends, in place of pytest's kept
    one: these tests write checkpoints of up to a few hundred MB."""
    with tempfile.TemporaryDirectory() as d:
        yield pathlib.Path(d)


@pytest.fixture(autouse=True)
def jax_globals(monkeypatch):
    for name in ("DENSE_CONV_MODE", "STENCIL_TRAIN", "CONV_WGRAD",
                 "QUANT_EVAL"):
        monkeypatch.setattr(jax_layers, name, getattr(jax_layers, name))


def _cfg(make):
    cfg = make()
    cfg.MODEL.NAME = "deeplabv3plus_resnettiny"
    cfg.MODEL.REDUCED_CHANNELS = 16
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.MODEL.WEIGHTS = ""
    return cfg


def torchvision_trunk(path, arch="resnettiny", seed=0):
    """The smoke's seeded torchvision-layout trunk file (``fc.*`` and
    BatchNorm counters included, as ImageNet files have them) at
    ``path``; returns its ``state_dict``."""
    return chip_smoke.write_torchvision_trunk(torch, path, arch, seed)


def test_pretrained_trunk_matches_jax(tmp_path):
    path = str(tmp_path / "resnettiny.pth")
    sd = torchvision_trunk(path)
    model = build_segmentor(_cfg(get_default_cfg), device="cpu")
    assert load_pretrained_backbone(model, path) == path
    trunk = model.feature_extractor.backbone.state_dict()
    for k, v in trunk.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, sd[k]), k

    jcfg = _cfg(jax_default_cfg)
    jmodel = jax_build_segmentor(jcfg)
    variables = jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, 64, 64, 3), jnp.float32), train=False)
    variables = jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float32),
                                       variables)
    state = jax_state.state_from_variables(
        variables, jax_build_optimizer(jcfg, 1)[0])
    state = jax_load_pretrained(state, path)
    x = np.random.default_rng(1).normal(size=(2, 64, 96, 3)).astype(
        np.float32)
    want = jax_resnet.resnet_feature_extractor("resnettiny", True).apply(
        {"params": state.params["feature_extractor"],
         "frozen": state.frozen["feature_extractor"]},
        jnp.asarray(x), train=False)
    with torch.no_grad():
        got = model.feature_extractor(torch.from_numpy(x).permute(0, 3, 1, 2))
    for k in ("low", "out"):
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].permute(0, 2, 3, 1).numpy(), w,
                                   rtol=0, atol=1e-5 * np.abs(w).max(),
                                   err_msg=k)


def test_learner_loads_weights_then_resume(mini_root, tmp_path):
    """``MODEL.WEIGHTS`` through the learner, then ``resume`` replaces each
    module its checkpoint holds."""
    path = str(tmp_path / "trunk.pth")
    sd = torchvision_trunk(path, seed=2)
    argv = _argv(mini_root, tmp_path, "w", resume="",
                 **{"MODEL.WEIGHTS": path})
    _, cfg = parse_args(argv)
    learner = TestLearner(cfg, device="cpu")
    trunk = learner.model.feature_extractor.backbone.state_dict()
    assert all(torch.equal(trunk[k], sd[k]) for k in trunk)
    ckpt = str(tmp_path / "model.ckpt")
    other = build_segmentor(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(4))
    torch.save({"state_dict": other.state_dict()}, ckpt)
    _, cfg = parse_args(argv + ["resume", ckpt])
    learner = TestLearner(cfg, device="cpu")
    want = other.state_dict()
    assert all(torch.equal(v, want[k])
               for k, v in learner.model.state_dict().items())


def test_pretrained_refusals(tmp_path, monkeypatch):
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "torch_home"))
    assert resolve_pretrained_weights("") is None
    with pytest.raises(FileNotFoundError, match="missing file"):
        resolve_pretrained_weights(str(tmp_path / "absent.pth"))
    url = "https://download.pytorch.org/models/resnet101-5d3b4d8f.pth"
    with pytest.raises(RuntimeError, match="not in the torch hub cache"):
        resolve_pretrained_weights(url)
    cached = tmp_path / "torch_home" / "hub" / "checkpoints"
    cached.mkdir(parents=True)
    (cached / "resnet101-5d3b4d8f.pth").write_bytes(b"")
    assert resolve_pretrained_weights(url) == str(
        cached / "resnet101-5d3b4d8f.pth")

    model = build_segmentor(_cfg(get_default_cfg), device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    path = str(tmp_path / "trunk.pth")
    sd = torchvision_trunk(path)
    renamed = dict(sd)
    renamed["layer9.0.conv1.weight"] = renamed.pop("layer1.0.conv1.weight")
    torch.save(renamed, path)
    with pytest.raises(RuntimeError, match="does not fit the trunk"):
        load_pretrained_backbone(model, path)
    reshaped = dict(sd)
    reshaped["conv1.weight"] = torch.zeros(64, 3, 5, 5)
    torch.save(reshaped, path)
    with pytest.raises(RuntimeError, match="has shape"):
        load_pretrained_backbone(model, path)
    torch.save({"head.weight": torch.zeros(3)}, path)
    with pytest.raises(RuntimeError, match="no tensor matches"):
        load_pretrained_backbone(model, path)
    # nothing was loaded by a refused file
    assert all(torch.equal(v, before[k])
               for k, v in model.state_dict().items())


def _jax_run(seed=0, steps=1):
    """A JAX tiny model and state after ``steps`` source_target steps."""
    jcfg = _cfg(jax_default_cfg)
    jcfg.SOLVER.WARMUP_ITERS = 0
    jcfg.SOLVER.NUM_ITER = 4
    jcfg.SOLVER.NEGATIVE_THRESHOLD = 0.2
    jmodel = jax_build_segmentor(jcfg)
    variables = jmodel.init(
        {"params": jax.random.PRNGKey(seed),
         "dropout": jax.random.PRNGKey(seed + 1)},
        jnp.zeros((1, 64, 64, 3), jnp.float32), train=False)
    variables = jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float32),
                                       variables)
    tx, _ = jax_build_optimizer(jcfg, 1)
    state = jax_state.state_from_variables(variables, tx)
    jstep = jax.jit(jax_make_train_step(jcfg, jmodel, tx, "source_target"))
    for i in range(steps):
        state, _ = jstep(state, jax.tree_util.tree_map(
            jnp.asarray, _batches(30 + i, 32)), jax.random.PRNGKey(i))
    return jcfg, jmodel, state, jstep


def test_jax_checkpoint_resumes_with_a_bf16_leaf(tmp_path):
    jcfg, jmodel, state, _ = _jax_run(steps=0)
    params = jax.tree_util.tree_map(lambda v: v, state.params)
    conv = params["feature_extractor"]["layer1_0"]["conv1"]
    conv["kernel"] = conv["kernel"].astype(jnp.bfloat16)
    state = state.replace(params=params)
    path = str(tmp_path / "last.ckpt")
    jax_state.save_checkpoint(state, path)
    assert is_jax_checkpoint(path)
    raw = serialization.msgpack_restore(open(path, "rb").read())
    assert raw["params"]["feature_extractor"]["layer1_0"]["conv1"][
        "kernel"].dtype == jnp.bfloat16

    x = np.random.default_rng(2).normal(size=(2, 64, 96, 3)).astype(
        np.float32)
    variables = jax.tree_util.tree_map(jnp.asarray, state.variables())
    logits, embed = jax.jit(lambda v, x: jmodel.apply(
        v, x, size=(64, 96), train=False))(variables, jnp.asarray(x))
    cfg = _cfg(get_default_cfg)
    model = build_segmentor(cfg, device="cpu")
    assert load_module_params(model, path, "feature_extractor")
    assert load_module_params(model, path, "classifier")
    w = model.feature_extractor.backbone.layer1[0].conv1.weight
    want = np.asarray(conv["kernel"].astype(jnp.float32)).transpose(
        3, 2, 0, 1)
    np.testing.assert_array_equal(w.detach().numpy(), want)
    with torch.no_grad():
        t_logits, t_embed = make_forward(model)(torch.from_numpy(x))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(logits), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(t_embed.numpy(), np.asarray(embed), rtol=0,
                               atol=1e-5)


def test_restore_state_from_a_jax_checkpoint(tmp_path, monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, inputs, *a, **k: inputs)
    jcfg, jmodel, state, jstep = _jax_run(steps=1)
    path = str(tmp_path / "last.ckpt")
    jax_state.save_checkpoint(state, path,
                              extra={"active_round": 3, "best_miou": 12.5})
    cfg = _cfg(get_default_cfg)
    cfg.merge_from_other_cfg(jcfg)
    model = build_segmentor(cfg, device="cpu")
    model.classifier.dropout.p = 0.0
    model.train()
    optimizer, scheduler, _ = build_optimizer(cfg, model)
    blob = restore_state(model, optimizer, scheduler, path)
    assert blob["step"] == 1
    assert blob["extra"] == {"active_round": 3, "best_miou": 12.5}
    assert scheduler.last_epoch == 1
    trace = _state_dict64(_momentum(state))
    for n, param in model.named_parameters():
        want = trace[n].numpy()
        got = optimizer.state[param]["momentum_buffer"].double().numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max(), err_msg=n)
    # the next step continues the JAX run
    b = _batches(40, 32)
    state, jmetrics = jstep(state, jax.tree_util.tree_map(jnp.asarray, b),
                            jax.random.PRNGKey(1))
    metrics = make_train_step(cfg, model, optimizer, "source_target")(
        {k: {n: torch.from_numpy(v) for n, v in d.items()}
         for k, d in b.items()})
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5,
                                   err_msg=k)

    # an optimizer state that does not map raises, and is never dropped
    raw = serialization.msgpack_restore(open(path, "rb").read())
    for opt_state in ({"count": np.int32(1)},
                      {"inner_states": {k: {"inner_state": {}} for k in
                                        ("fea", "cls")}}):
        raw["opt_state"] = opt_state
        bad = str(tmp_path / "bad.ckpt")
        with open(bad, "wb") as f:
            f.write(serialization.msgpack_serialize(raw))
        with pytest.raises(ValueError, match="momentum|two-group"):
            restore_state(model, optimizer, scheduler, bad)
