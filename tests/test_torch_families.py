"""Port parity, the model families: every DeepLab head x ``MODEL.HYPER``
on resnettiny and on a grouped (ResNeXt-style) tiny trunk, the trunks'
kernel-C routing, ``TPU.REMAT``, two ``source_target`` steps of the
DeepLab-v2 hyperbolic and the RIPU (Euclidean v3+, 512 channels, LCR)
models, and the rich eval and ``TestLearner`` of the Euclidean heads,
against the JAX package from the same weights (the JAX init carried
across by ``models.convert``), float32 compute.

Tolerances: logits atol 1e-4 and ball embeddings atol 1e-5, as in
tests/test_torch_models.py; the Euclidean v3+ decoder features (not
bounded like a ball embedding) within 1e-5 of their max; argmax agreement
>= 99.9%. The steps: loss terms within 1e-5 relative and step 0's
momentum buffers within 1e-4 of their max, as in
tests/test_torch_train.py; step 1's loss terms within 1e-4 relative.
``TPU.REMAT`` changes nothing: parameters, gradients, momentum buffers and
running statistics equal bit for bit after two steps.
"""

import os
import pathlib
import tempfile

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo_tpu.config import get_default_cfg as jax_default_cfg
from halo_tpu.engine.optim import build_optimizer as jax_build_optimizer
from halo_tpu.engine.state import state_from_variables
from halo_tpu.engine.steps import make_rich_eval_step as jax_rich_step
from halo_tpu.engine.steps import make_train_step as jax_make_train_step
from halo_tpu.models import build as jax_build
from halo_tpu.models import layers as jax_layers
from halo_tpu.models import resnet as jax_resnet
from halo_tpu.models.port_torch import torch_state_dict_to_variables
from halo_tpu_torch.config import get_default_cfg
from halo_tpu_torch.engine import make_forward
from halo_tpu_torch.engine.learners import TestLearner
from halo_tpu_torch.engine.optim import build_optimizer
from halo_tpu_torch.engine.state import save_checkpoint
from halo_tpu_torch.engine.steps import make_rich_eval_step, make_train_step
from halo_tpu_torch.models import build_segmentor, variables_to_state_dict
from halo_tpu_torch.models import build as port_build
from halo_tpu_torch.models.layers import DilatedConv3x3
from halo_tpu_torch.models.resnet import (ARCHS, FeatureExtractor,
                                          ResNetFeatures)
from halo_tpu_torch.utils.misc import parse_args
from tests.test_torch_eval import _argv, _jax_test, _same_result
from tests.test_torch_train import _batches, _momentum, _state_dict64

# (head, MODEL.HYPER, REDUCED_CHANNELS, HFR): both v2 heads, the v3+
# Euclidean head's three layouts (old_decoder, reduce + HFR, HFR at 512)
# and the hyperbolic v3+ head.
HEADS = [("deeplabv2", False, 64, False), ("deeplabv2", True, 16, False),
         ("deeplabv3plus", False, 512, False),
         ("deeplabv3plus", False, 16, True),
         ("deeplabv3plus", False, 512, True),
         ("deeplabv3plus", True, 16, True)]


def _ids(head):
    name, hyper, reduced, hfr = head
    return f"{name}-{'hyper' if hyper else 'euclid'}-{reduced}" + (
        "-hfr" if hfr else "")


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


def _configure(cfg, head, backbone="resnettiny"):
    name, hyper, reduced, hfr = head
    cfg.MODEL.NAME = f"{name}_{backbone}"
    cfg.MODEL.HYPER = hyper
    cfg.MODEL.REDUCED_CHANNELS = reduced
    cfg.MODEL.HFR = hfr
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def _jax_variables(jmodel, seed=0):
    variables = jmodel.init(
        {"params": jax.random.PRNGKey(seed),
         "dropout": jax.random.PRNGKey(seed + 1)},
        jnp.zeros((1, 64, 64, 3), jnp.float32), train=False)
    return jax.tree_util.tree_map(lambda v: np.asarray(v, np.float32),
                                  dict(variables))


def _hold(got, want):
    """(logits, aux) of the port against the JAX model's: aux within 1e-5
    absolute, or of its max where that exceeds 1."""
    logits, aux = (np.asarray(x) if x is not None else None for x in want)
    t_logits, t_aux = got
    assert t_logits.shape == logits.shape
    np.testing.assert_allclose(t_logits.float().numpy(), logits, rtol=0,
                               atol=1e-4)
    agree = (t_logits.numpy().argmax(-1) == logits.argmax(-1)).mean()
    assert agree >= 0.999
    assert (t_aux is None) == (aux is None)
    if aux is not None:
        assert t_aux.shape == aux.shape
        np.testing.assert_allclose(t_aux.float().numpy(), aux, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(aux).max()))


@pytest.mark.parametrize("head", HEADS, ids=_ids)
def test_head_matches_jax(head):
    """Each head on resnettiny: the port's state_dict is the upstream
    layout (the JAX package's own importer carries it back bit for bit)
    and the forward matches."""
    jcfg = _configure(jax_default_cfg(), head)
    cfg = _configure(get_default_cfg(), head)
    jmodel = jax_build.build_segmentor(jcfg)
    variables = _jax_variables(jmodel)
    sd = variables_to_state_dict(variables)
    model = build_segmentor(cfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    kind = "deeplabv2" if head[0] == "deeplabv2" else "deeplabv3plus"
    numpy_sd = {k: v.numpy() for k, v in sd.items()}
    for module in ("feature_extractor", "classifier"):
        back = torch_state_dict_to_variables(numpy_sd, module, head=kind)
        for col in ("params", "frozen"):
            want = jax.tree_util.tree_leaves_with_path(
                variables.get(col, {}).get(module, {}))
            got = dict(jax.tree_util.tree_leaves_with_path(back[col]))
            assert len(got) == len(want), (module, col)
            for path, leaf in want:
                np.testing.assert_array_equal(got[path], leaf)

    x = np.random.default_rng(0).normal(size=(2, 64, 96, 3)).astype(
        np.float32)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, size=(64, 96),
                                             train=False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = make_forward(model)(torch.from_numpy(x))
    _hold(got, want)
    if head[0] == "deeplabv2" and head[1]:
        assert got[1].shape == (2, 64, 96, 16)  # embed resized to size


@pytest.mark.parametrize("head", [HEADS[5], HEADS[0]], ids=_ids)
def test_grouped_trunk_matches_jax(head):
    """A ResNeXt-style tiny trunk (32 groups of width 4) built directly in
    both packages, under each head: grouped 3x3 kernels carry over like
    dense ones."""
    jcfg = _configure(jax_default_cfg(), head)
    cfg = _configure(get_default_cfg(), head)
    jmodel = jax_build.Segmentor(
        feature_extractor=jax_resnet.ResNetFeatures(
            stage_sizes=(1, 1, 1, 1), groups=32, base_width=4,
            freeze_bn=True),
        classifier=jax_build.build_classifier(jcfg))
    variables = _jax_variables(jmodel, seed=3)
    kernel = variables["params"]["feature_extractor"]["layer1_0"]["conv2"][
        "kernel"]
    assert kernel.shape == (3, 3, 4, 128)
    model = port_build.Segmentor(
        FeatureExtractor(ResNetFeatures(
            stage_sizes=(1, 1, 1, 1), groups=32, base_width=4,
            freeze_bn=True, dense_conv_mode="pallas")),
        port_build.build_classifier(cfg)).eval()
    model.compute_dtype = torch.float32
    model.load_state_dict(variables_to_state_dict(variables), strict=True)
    conv2 = model.feature_extractor.backbone.layer4[0].conv2
    assert conv2.groups == 32 and not isinstance(conv2, DilatedConv3x3)

    x = np.random.default_rng(1).normal(size=(2, 64, 96, 3)).astype(
        np.float32)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, size=(64, 96),
                                             train=False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = make_forward(model)(torch.from_numpy(x))
    _hold(got, want)


@pytest.mark.parametrize("arch,want", [
    ("resnettiny", 1), ("resnet50", 8), ("resnet101", 25),
    ("resnet152", 38), ("resnext50_32x4d", 0), ("resnext101_32x8d", 0)])
def test_kernel_c_routing_of_each_trunk(arch, want):
    """Under ``pallas`` the ungrouped dilated 3x3 convs of layer3 (after
    its first block) and layer4 go to kernel C; grouped convs stay cuDNN
    convs. The stage sizes, groups and widths are the JAX package's."""
    assert ARCHS[arch] == jax_resnet._ARCHS[arch]
    with torch.device("meta"):
        trunk = ResNetFeatures(*ARCHS[arch][:1], groups=ARCHS[arch][1],
                               base_width=ARCHS[arch][2], freeze_bn=True,
                               dense_conv_mode="pallas")
    convs = [m for m in trunk.modules() if isinstance(m, DilatedConv3x3)]
    assert len(convs) == want
    assert all(m.groups == 1 and m.dilation[0] >= 2 for m in convs)


def _run_steps(model, cfg, seed, steps=2):
    optimizer, scheduler, _ = build_optimizer(cfg, model)
    step = make_train_step(cfg, model, optimizer, "source_target")
    torch.manual_seed(seed)
    for i in range(steps):
        b = _batches(20 + i, 32)
        step({k: {n: torch.from_numpy(v) for n, v in d.items()}
              for k, d in b.items()})
        scheduler.step()
    return optimizer


@pytest.mark.parametrize("freeze_bn", [True, False],
                         ids=["frozen_bn", "live_bn"])
def test_remat_changes_nothing(freeze_bn):
    """Two train steps with live head dropout, with and without
    ``TPU.REMAT``: the recompute leaves BatchNorm's running statistics and
    the RNG stream as the forward left them."""
    runs = []
    for remat in (False, True):
        cfg = _configure(get_default_cfg(), HEADS[5])
        cfg.MODEL.FREEZE_BN = freeze_bn
        cfg.TPU.REMAT = remat
        cfg.TPU.DENSE_CONV_MODE = "pallas"
        cfg.SOLVER.WARMUP_ITERS = 0
        model = build_segmentor(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(0))
        model.train()
        assert model.feature_extractor.backbone.remat == remat
        calls = []
        conv = model.feature_extractor.backbone.layer4[0].conv2
        conv.register_forward_hook(lambda *a: calls.append(1))
        optimizer = _run_steps(model, cfg, seed=7)
        runs.append((model, optimizer, len(calls)))
    (plain, opt_p, n_plain), (remat, opt_r, n_remat) = runs
    # two forwards a step; the recompute runs each block's forward again
    assert n_plain == 4 and n_remat == 8
    for (name, a), b in zip(plain.named_parameters(), remat.parameters()):
        assert torch.equal(a, b), name
        assert torch.equal(a.grad, b.grad), name
        assert torch.equal(opt_p.state[a]["momentum_buffer"],
                           opt_r.state[b]["momentum_buffer"]), name
    buffers = dict(remat.named_buffers())
    for name, buf in plain.named_buffers():
        assert torch.equal(buf, buffers[name]), name
    if not freeze_bn:
        bn = plain.feature_extractor.backbone.layer1[0].bn1
        assert int(bn.num_batches_tracked) == 4


def _step_cfgs(head, **solver):
    cfgs = []
    for make in (jax_default_cfg, get_default_cfg):
        cfg = _configure(make(), head)
        cfg.SOLVER.BASE_LR = 1e-3
        cfg.SOLVER.WARMUP_ITERS = 0
        cfg.SOLVER.NUM_ITER = 4
        # above every probability of a random init (test_torch_train.py)
        cfg.SOLVER.NEGATIVE_THRESHOLD = 0.2
        for k, v in solver.items():
            setattr(cfg.SOLVER, k, v)
        cfgs.append(cfg)
    return cfgs


@pytest.mark.parametrize("head,solver", [
    (HEADS[1], {}), (HEADS[2], {"CONSISTENT_LOSS": 0.1})],
    ids=["deeplabv2-hyper", "ripu"])
def test_two_source_target_steps_match_jax(head, solver, monkeypatch):
    """The JAX model on XLA's convs, the port on kernel C's plain version;
    dropout the identity in both."""
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, inputs, *a, **k: inputs)
    jcfg, cfg = _step_cfgs(head, **solver)
    cfg.TPU.DENSE_CONV_MODE = "pallas"
    jmodel = jax_build.build_segmentor(jcfg)
    variables = _jax_variables(jmodel, seed=5)
    tx, _ = jax_build_optimizer(jcfg, 1)
    state = state_from_variables(
        jax.tree_util.tree_map(jnp.asarray, variables), tx)
    jstep = jax.jit(jax_make_train_step(jcfg, jmodel, tx, "source_target"))

    model = build_segmentor(cfg, device="cpu")
    model.load_state_dict(variables_to_state_dict(variables), strict=True)
    if hasattr(model.classifier, "dropout"):
        model.classifier.dropout.p = 0.0
    model.train()
    optimizer, scheduler, _ = build_optimizer(cfg, model)
    step = make_train_step(cfg, model, optimizer, "source_target")
    terms = {"loss_sup", "loss_sup_tgt", "negative_loss", "loss"} | (
        {"consistency_loss"} if solver else set())
    for i in range(2):
        b = _batches(10 + i, 64)
        state, jmetrics = jstep(state, jax.tree_util.tree_map(
            jnp.asarray, b), jax.random.PRNGKey(i))
        metrics = step({k: {n: torch.from_numpy(v) for n, v in d.items()}
                        for k, d in b.items()})
        scheduler.step()
        assert set(metrics) == set(jmetrics) == terms
        for k, v in jmetrics.items():
            np.testing.assert_allclose(float(metrics[k]), float(v),
                                       rtol=1e-5 if i == 0 else 1e-4,
                                       err_msg=f"step {i} {k}")
        if i == 0:
            trace = _state_dict64(_momentum(state))
            for n, param in model.named_parameters():
                want = trace[n].numpy()
                got = optimizer.state[param]["momentum_buffer"].numpy()
                np.testing.assert_allclose(
                    got, want, rtol=0,
                    atol=1e-4 * float(np.abs(want).max()), err_msg=n)


EUCLID = [("deeplabv2", False, 64, False), ("deeplabv3plus", False, 512,
                                             False)]


@pytest.mark.parametrize("head", EUCLID, ids=_ids)
def test_rich_eval_step_matches_jax(head):
    """No embedding from the v2 Euclidean head; the v3+ head's 512-channel
    decoder features and their radius (through the same entry as kernel
    B's) from the other."""
    jcfg = _configure(jax_default_cfg(), head)
    cfg = _configure(get_default_cfg(), head)
    jmodel = jax_build.build_segmentor(jcfg)
    variables = _jax_variables(jmodel, seed=2)
    state = state_from_variables(
        jax.tree_util.tree_map(jnp.asarray, variables),
        jax_build_optimizer(jcfg, 1)[0])
    model = build_segmentor(cfg, device="cpu")
    model.load_state_dict(variables_to_state_dict(variables), strict=True)
    model.eval()
    rng = np.random.default_rng(4)
    img = rng.normal(size=(1, 40, 72, 3)).astype(np.float32)
    label = rng.integers(0, 19, (1, 50, 90)).astype(np.int32)
    want = jax.device_get(jax_rich_step(jcfg, jmodel)(
        state, jnp.asarray(img), jnp.asarray(label), flip=True))
    got = make_rich_eval_step(cfg, model)(
        torch.from_numpy(img), torch.from_numpy(label).long(), flip=True)
    got = {k: v.numpy() for k, v in got.items()}
    assert set(got) == set(want)
    assert ("embed" in got) == (head[0] == "deeplabv3plus")
    np.testing.assert_allclose(got["prob"], want["prob"], rtol=0, atol=1e-5)
    assert np.mean(got["pred"] == want["pred"]) >= 0.999
    if "embed" in got:
        assert got["embed"].shape == (1, 10, 18, 512)
        scale = float(np.abs(want["embed"]).max())
        np.testing.assert_allclose(got["embed"], want["embed"], rtol=0,
                                   atol=1e-5 * scale)
        np.testing.assert_allclose(got["radius"], want["radius"], rtol=1e-5)


@pytest.mark.parametrize("head", EUCLID, ids=_ids)
def test_test_learner_matches_jax(head, mini_root, tmp_path, monkeypatch):
    """``TestLearner`` with ``TEST.SAVE_EMBED`` on a port checkpoint of the
    Euclidean heads (the JAX package loads it through its own importer):
    the same metrics and artifacts, 'embed' only where the head returns
    features; the v2 head also plots its wrong predictions (a zero radius
    map, as the JAX package draws it)."""
    cfg = _configure(get_default_cfg(), head)
    model = build_segmentor(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(9))
    ckpt = str(tmp_path / "model.ckpt")
    save_checkpoint(model, ckpt, optimizer=build_optimizer(cfg, model)[0])
    viz = head[0] == "deeplabv2"
    extra = {"MODEL.NAME": cfg.MODEL.NAME, "MODEL.HYPER": False,
             "MODEL.REDUCED_CHANNELS": head[2], "MODEL.HFR": False,
             "TEST.SAVE_EMBED": True, "TEST.VIZ_WRONG": viz}
    argv = _argv(mini_root, tmp_path, "port", resume=ckpt, **extra)
    jcfg, want = _jax_test(argv)
    _, pcfg = parse_args(argv)
    got = TestLearner(pcfg, device="cpu").test()
    _same_result(got, want, 19)
    names = sorted(os.listdir(os.path.join(jcfg.SAVE_DIR, "embed")))
    assert names == sorted(os.listdir(os.path.join(pcfg.SAVE_DIR, "embed")))
    assert len(names) == 3
    for name in names:
        a = torch.load(os.path.join(pcfg.SAVE_DIR, "embed", name))
        b = torch.load(os.path.join(jcfg.SAVE_DIR, "embed", name))
        assert {k: (v.dtype, v.shape) for k, v in a.items()} == {
            k: (v.dtype, v.shape) for k, v in b.items()}
        assert ("embed" in a) == (head[0] == "deeplabv3plus")
        torch.testing.assert_close(a["output"], b["output"], rtol=0,
                                   atol=1e-5)
        if "embed" in a:
            assert a["embed"].shape[-1] == 512
            scale = float(b["embed"].abs().max())
            torch.testing.assert_close(a["embed"], b["embed"], rtol=0,
                                       atol=1e-5 * scale)
    if viz:
        wrong = [sorted(os.listdir(os.path.join(d, "viz", "wrong")))
                 for d in (pcfg.SAVE_DIR, jcfg.SAVE_DIR)]
        assert wrong[0] == wrong[1] and len(wrong[0]) == 1


CONFIGS = os.path.join(os.path.dirname(__file__), os.pardir, "configs")
PIPELINES = {
    "ripu": ("gtav/ripu.yaml", {"MODEL.NAME": "deeplabv3plus_resnettiny"}),
    "deeplabv2-hyper": ("gtav/source_target.yaml", {
        "MODEL.NAME": "deeplabv2_resnettiny", "MODEL.REDUCED_CHANNELS": 16}),
    "deeplabv2-euclid": ("gtav/source_target.yaml", {
        "MODEL.NAME": "deeplabv2_resnettiny", "MODEL.HYPER": False,
        "ACTIVE.PURITY": "ripu"}),
    "random": ("gtav/source_target.yaml", {
        "MODEL.NAME": "deeplabv3plus_resnettiny",
        "MODEL.REDUCED_CHANNELS": 16, "ACTIVE.UNCERTAINTY": "random"}),
}


@pytest.mark.parametrize("run", sorted(PIPELINES))
def test_recipe_runs_round_steps_validation_and_test(run, mini_root,
                                                     tmp_path):
    """``train.main`` on the CPU: round 1 at step 0, two steps, validation,
    checkpoints; then ``halo_tpu_torch.test.main`` on its ``last.ckpt``
    with the artifacts. (The v2 Euclidean head has no embedding, so it
    runs with the RIPU purity: a radius purity refuses it.)"""
    from halo_tpu_torch import test as test_entry
    from halo_tpu_torch import train
    from halo_tpu_torch.data import mask_cache

    recipe, extra = PIPELINES[run]
    argv = ["-cfg", os.path.join(CONFIGS, recipe), "MODEL.WEIGHTS", "",
            "resume", "", "TPU.DENSE_CONV_MODE", "pallas",
            "TPU.COMPUTE_DTYPE", "float32", "TPU.LOADER_WORKERS", "0",
            "INPUT.SOURCE_INPUT_SIZE_TRAIN", "(48, 24)",
            "INPUT.TARGET_INPUT_SIZE_TRAIN", "(48, 24)",
            "INPUT.INPUT_SIZE_TEST", "(48, 24)", "SOLVER.NUM_ITER", "2",
            "ACTIVE.SELECT_ITER", "[0]", "TPU.VAL_INTERVAL", "2",
            "TPU.DATASET_DIR", str(mini_root), "OUTPUT_DIR", str(tmp_path)]
    argv += [str(x) for k, v in extra.items() for x in (k, v)]
    mask_cache.clear()
    learner = train.main(argv + ["NAME", run], device="cpu")
    assert [r["step"] for r in learner.history] == [0, 1]
    assert all(np.isfinite(v) for r in learner.history
               for k, v in r.items() if k.startswith("loss"))
    assert learner.active_round == 2 and np.isfinite(learner.best_miou)
    save_dir = learner.cfg.SAVE_DIR
    masks = os.listdir(os.path.join(save_dir, "gtMask", "train", "city0"))
    assert len(masks) == 1
    ckpt = os.path.join(save_dir, "last.ckpt")
    result = test_entry.main(argv + ["NAME", run + "_test", "resume", ckpt,
                                     "TEST.SAVE_EMBED", "True"],
                             device="cpu")
    assert np.isfinite(result["mIoU"])
    arts = os.listdir(os.path.join(str(tmp_path), run + "_test", "embed"))
    blob = torch.load(os.path.join(str(tmp_path), run + "_test", "embed",
                                   arts[0]))
    assert ("embed" in blob) == (run != "deeplabv2-euclid")


def test_radius_purity_refuses_a_head_without_embedding(mini_root,
                                                         tmp_path):
    from halo_tpu_torch.active.region_selection import region_selection
    from halo_tpu_torch.data.build import build_active_loader
    from halo_tpu_torch.data.catalog import DatasetCatalog
    from tests.conftest import make_mini_cfg

    cfg = _configure(make_mini_cfg(mini_root, tmp_path), HEADS[0])
    pcfg = get_default_cfg()
    pcfg.set_new_allowed(True)
    pcfg.merge_from_other_cfg(cfg)
    pcfg.ACTIVE.PURITY = "radius"
    DatasetCatalog.init_mask(pcfg)
    model = build_segmentor(pcfg, device="cpu")
    with pytest.raises(ValueError, match="returns none"):
        region_selection(pcfg, model, build_active_loader(pcfg, 0), 1,
                         device="cpu")
