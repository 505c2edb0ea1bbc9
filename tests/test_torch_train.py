"""Port parity, the train step: losses, the LR schedule, two-group SGD,
train transforms and datasets, two source_target steps of resnettiny with
kernel C's route, and checkpoints the JAX package loads.

Inputs are made with numpy and go to both packages as float32 (the test
process runs JAX with x64 on). Where the JAX model reaches kernel C it runs
the Pallas kernel in interpret mode, as tests/test_dense_conv.py does; the
JAX package's process-wide conv globals are restored by monkeypatch.
"""

import os
import random
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from halo_tpu import losses as jl
from halo_tpu.config import get_default_cfg as jax_default_cfg
from halo_tpu.data import transforms as JT
from halo_tpu.data.build import build_dataset as jax_build_dataset
from halo_tpu.data.catalog import DatasetCatalog as JaxCatalog
from halo_tpu.data.loader import DataLoader as JaxLoader
from halo_tpu.engine import optim as jax_optim
from halo_tpu.engine import steps as jax_steps
from halo_tpu.engine.optim import build_optimizer as jax_build_optimizer
from halo_tpu.engine.optim import torch_warmup_poly_schedule
from halo_tpu.engine.state import state_from_variables
from halo_tpu.engine.steps import make_train_step as jax_make_train_step
from halo_tpu.losses import losses as jax_losses_mod
from halo_tpu.models import build as jax_build
from halo_tpu.models import classifier as jax_classifier
from halo_tpu.models import layers as jax_layers
from halo_tpu.models import resnet as jax_resnet
from halo_tpu.models.build import build_segmentor as jax_build_segmentor
from halo_tpu.models.port_torch import load_torch_module_params
from halo_tpu.ops import pallas_conv
from halo_tpu_torch import losses as tl
from halo_tpu_torch.config import get_default_cfg
from halo_tpu_torch.data import transforms as TT
from halo_tpu_torch.data.build import build_dataset, build_train_loader
from halo_tpu_torch.engine.optim import build_optimizer
from halo_tpu_torch.engine.state import (load_module_params,
                                         load_state_dict_file,
                                         save_checkpoint)
from halo_tpu_torch.engine.steps import make_train_step
from halo_tpu_torch.models import build_segmentor, variables_to_state_dict
from halo_tpu_torch.models.layers import DilatedConv3x3
from tests.conftest import make_mini_cfg


def _f32(x):
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def _logits_labels(seed, ignore_share=0.3):
    rng = np.random.default_rng(seed)
    logits = _f32(rng.normal(size=(2, 12, 16, 19)) * 3)
    labels = rng.integers(0, 19, (2, 12, 16)).astype(np.int32)
    labels[rng.random(labels.shape) < ignore_share] = 255
    return logits, labels


@pytest.mark.parametrize("weighted", [False, True])
def test_cross_entropy_matches_jax(weighted):
    logits, labels = _logits_labels(0)
    weight = _f32(np.linspace(0.5, 2.0, 19)) if weighted else None
    want, want_g = jax.value_and_grad(
        lambda z: jl.cross_entropy_loss(z, jnp.asarray(labels), 255,
                                        weight))(jnp.asarray(logits))
    z = torch.from_numpy(logits).requires_grad_(True)
    got = tl.cross_entropy_loss(z, torch.from_numpy(labels).long(), 255,
                                weight)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(want_g),
                               rtol=1e-5, atol=1e-9)


def test_cross_entropy_all_ignored_is_exactly_zero():
    logits, _ = _logits_labels(1)
    labels = np.full((2, 12, 16), 255, np.int32)
    want = jl.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels))
    z = torch.from_numpy(logits).requires_grad_(True)
    got = tl.cross_entropy_loss(z, torch.from_numpy(labels))
    got.backward()
    assert float(want) == 0.0 and got.item() == 0.0
    assert not torch.isnan(z.grad).any() and float(z.grad.abs().max()) == 0


def test_negative_learning_matches_jax():
    logits, _ = _logits_labels(2)
    p = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    want, want_g = jax.value_and_grad(
        lambda z: jl.negative_learning_loss(jax.nn.softmax(z, -1), 0.05))(
        jnp.asarray(logits))
    z = torch.from_numpy(logits).requires_grad_(True)
    got = tl.negative_learning_loss(torch.softmax(z, -1), 0.05)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(want_g),
                               rtol=1e-5, atol=1e-9)
    assert float(jl.negative_learning_loss(p, 0.0)) == 0.0
    assert float(tl.negative_learning_loss(
        torch.tensor(np.asarray(p, np.float32)), 0.0)) == 0.0


@pytest.mark.parametrize("l_type", ["l1", "kl"])
def test_local_consistent_matches_jax(l_type):
    logits, labels = _logits_labels(3, ignore_share=0.1)
    want, want_g = jax.value_and_grad(
        lambda z: jl.local_consistent_loss(z, jnp.asarray(labels), l_type))(
        jnp.asarray(logits))
    z = torch.from_numpy(logits).requires_grad_(True)
    got = tl.local_consistent_loss(z, torch.from_numpy(labels), l_type)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(want_g),
                               rtol=1e-4, atol=1e-8)


# ---------------------------------------------------------------------------
# Schedule and optimizer
# ---------------------------------------------------------------------------

def _toy_model():
    torch.manual_seed(0)
    model = torch.nn.Module()
    model.feature_extractor = torch.nn.Linear(4, 3)
    model.classifier = torch.nn.Linear(3, 2)
    return model


@pytest.mark.parametrize("warmup,total", [(600, 60000), (4, 9), (0, 5)])
def test_schedule_matches_jax_at_pinned_steps(warmup, total):
    cfg = get_default_cfg()
    cfg.SOLVER.WARMUP_ITERS = warmup
    cfg.SOLVER.NUM_ITER = total
    optimizer, scheduler, lr_at = build_optimizer(cfg, _toy_model())
    base = cfg.SOLVER.BASE_LR
    fea = torch_warmup_poly_schedule(base, warmup, total, 0.5)
    cls = torch_warmup_poly_schedule(base * 10, warmup, total, 0.5)
    pinned = [0, max(warmup - 1, 0), warmup, total - 1]
    # the LR in force at each step, stepping the scheduler after every
    # optimizer step (the recipe's 60k steps: through the warmup only)
    stepped = np.arange(min(total, warmup + 2))
    want_fea, want_cls = np.asarray(fea(stepped)), np.asarray(cls(stepped))
    got = []
    for _step in stepped:
        got.append([g["lr"] for g in optimizer.param_groups])
        optimizer.step()
        scheduler.step()
    np.testing.assert_allclose(np.asarray(got),
                               np.stack([want_fea, want_cls], 1), rtol=1e-6)
    for step in pinned:
        want = [float(fea(step)), float(cls(step))]
        np.testing.assert_allclose(
            [g["initial_lr"] * f(step) for g, f in
             zip(optimizer.param_groups, scheduler.lr_lambdas)], want,
            rtol=1e-6)
        np.testing.assert_allclose(
            [lr_at(step)["lr_fea"], lr_at(step)["lr_cls"]], want, rtol=1e-6)


def test_two_group_sgd_matches_optax():
    cfg = get_default_cfg()
    cfg.SOLVER.BASE_LR = 0.01
    cfg.SOLVER.WARMUP_ITERS = 2
    cfg.SOLVER.NUM_ITER = 10
    model = _toy_model()
    optimizer, scheduler, _ = build_optimizer(cfg, model)
    params = {m: {n: jnp.asarray(_f32(p.detach().numpy()))
                  for n, p in getattr(model, m).named_parameters()}
              for m in ("feature_extractor", "classifier")}
    tx, _ = jax_build_optimizer(cfg, 1)
    opt_state = tx.init(params)
    rng = np.random.default_rng(0)
    for _step in range(3):
        grads = {m: {n: _f32(rng.normal(size=v.shape)) for n, v in t.items()}
                 for m, t in params.items()}
        updates, opt_state = tx.update(
            jax.tree_util.tree_map(jnp.asarray, grads), opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        for m, t in grads.items():
            for n, g in t.items():
                getattr(model, m).get_parameter(n).grad = torch.from_numpy(g)
        optimizer.step()
        scheduler.step()
        for m, t in params.items():
            for n, v in t.items():
                np.testing.assert_allclose(
                    getattr(model, m).get_parameter(n).detach().numpy(),
                    np.asarray(v), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# Train transforms, datasets and the loader
# ---------------------------------------------------------------------------

def test_train_transforms_match_jax():
    rng = np.random.default_rng(0)
    img = Image.fromarray(rng.integers(0, 256, (30, 52, 3), np.uint8))
    pair = rng.integers(0, 20, (30, 52, 2)).astype(np.uint8)
    mean, std = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]

    def chain(T):
        return T.Compose([T.RandomScale((0.5, 1.5), size=(24, 40)),
                          T.RandomCrop((32, 48)), T.RandomHorizontalFlip(),
                          T.ToArray(), T.Normalize(mean, std)])

    for seed in range(4):
        want = chain(JT)(img, pair, random.Random(seed))
        got = chain(TT)(img, pair, random.Random(seed))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    pil = Image.fromarray(pair[..., 0])
    want = JT.Resize((20, 36))(img, pil)
    got = TT.Resize((20, 36))(img, pil)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))


def _data_cfgs(mini_root, tmp_path):
    cfg = make_mini_cfg(mini_root, tmp_path)
    cfg.INPUT.INPUT_SCALES_TRAIN = (0.8, 1.2)
    pcfg = get_default_cfg()
    pcfg.set_new_allowed(True)
    pcfg.merge_from_other_cfg(cfg)
    JaxCatalog.init_mask(cfg)
    return cfg, pcfg


@pytest.mark.parametrize("is_source", [True, False])
def test_train_datasets_match_jax(mini_root, tmp_path, is_source):
    cfg, pcfg = _data_cfgs(mini_root, tmp_path)
    want = jax_build_dataset(cfg, "train", is_source=is_source)
    got = build_dataset(pcfg, "train", is_source=is_source)
    assert len(got) == len(want) > 0
    assert ([e["name"] for e in got.data_list]
            == [e["name"] for e in want.data_list])
    for i in range(3):
        a = got.__getitem__(i, rng=random.Random(i))
        b = want.__getitem__(i, rng=random.Random(i))
        np.testing.assert_array_equal(a["img"], b["img"])
        np.testing.assert_array_equal(a["label"], b["label"])
        if not is_source:
            np.testing.assert_array_equal(a["mask"], b["mask"])


def test_train_loader_batches_match_jax(mini_root, tmp_path):
    cfg, pcfg = _data_cfgs(mini_root, tmp_path)
    want = JaxLoader(jax_build_dataset(cfg, "train", is_source=False),
                     batch_size=2, shuffle=True, num_workers=1, seed=3,
                     drop_last=True)
    got = build_train_loader(pcfg, False, 2, 3, num_workers=0)
    for epoch in (0, 1):
        got.batch_sampler.set_epoch(epoch)
        jb, pb = list(want), list(got)
        assert len(jb) == len(pb) == 4
        for a, b in zip(pb, jb):
            assert a["name"] == b["name"]
            np.testing.assert_array_equal(a["img"], b["img"])
            np.testing.assert_array_equal(a["label"], b["label"])


# ---------------------------------------------------------------------------
# Two source_target steps of resnettiny through kernel C's route
# ---------------------------------------------------------------------------

def _step_cfg(make):
    cfg = make()
    cfg.MODEL.NAME = "deeplabv3plus_resnettiny"
    cfg.MODEL.REDUCED_CHANNELS = 16
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.DENSE_CONV_MODE = "pallas"
    # the recipe's LR, without the warmup's 0.01 factor
    cfg.SOLVER.BASE_LR = 1e-3
    cfg.SOLVER.WARMUP_ITERS = 0
    cfg.SOLVER.NUM_ITER = 4
    # The random init's softmax is near uniform (p ~ 1/19), so with the
    # recipe's threshold 0.05 some probabilities sit within float32
    # rounding of the negative-learning mask's step, and the two packages
    # mask different pixels. Above every probability the mask is constant
    # and the term is smooth (its threshold is pinned in the loss test).
    cfg.SOLVER.NEGATIVE_THRESHOLD = 0.2
    return cfg


@pytest.fixture
def jax_pallas(monkeypatch):
    """Kernel C in interpret mode, dropout the identity, and the JAX
    package's conv globals restored afterwards."""
    for name in ("DENSE_CONV_MODE", "STENCIL_TRAIN", "CONV_WGRAD",
                 "QUANT_EVAL"):
        monkeypatch.setattr(jax_layers, name, getattr(jax_layers, name))
    monkeypatch.setattr(pallas_conv, "INTERPRET", True)
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, inputs, *a, **k: inputs)


def _batches(seed, size=64):
    rng = np.random.default_rng(seed)

    def labels(share_labeled):
        lab = rng.integers(0, 19, (2, size, size)).astype(np.int32)
        lab[rng.random(lab.shape) > share_labeled] = 255
        return lab

    return {"source": {"img": _f32(rng.normal(size=(2, size, size, 3))),
                       "label": labels(0.9)},
            "target": {"img": _f32(rng.normal(size=(2, size, size, 3))),
                       "label": labels(0.9), "mask": labels(0.05)}}


def _momentum(state):
    """The SGD momentum buffers of a JAX TrainState as one param tree (the
    two groups' optax traces, each masked to its own leaves, merged)."""
    masked = lambda x: isinstance(x, optax.MaskedNode)  # noqa: E731
    traces = [s.trace for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda x: isinstance(x, optax.TraceState))
        if isinstance(s, optax.TraceState)]
    assert len(traces) == 2
    merged = jax.tree_util.tree_map(lambda a, b: b if masked(a) else a,
                                    traces[0], traces[1], is_leaf=masked)
    return jax.tree_util.tree_map(np.asarray, merged)


class _Float32IsFloat64(types.ModuleType):
    """``jax.numpy`` with ``float32`` read as ``float64``: put in place of
    a JAX module's ``jnp``, it turns that module's explicit float32 casts
    and compute dtype into float64."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


# The JAX modules of the train step that cast to float32 by name.
# ops.hyperbolic is left out: it only reads float32 to pick its artanh
# clamp, which must stay the float64 one, as in the port.
_F32_CASTING = (jax_layers, jax_classifier, jax_resnet, jax_build,
                jax_losses_mod, jax_steps, jax_optim)


def _state_dict64(tree):
    """``variables_to_state_dict`` of a param tree without its float32
    rounding: the float64 leaves are split into three float32 parts (72
    bits hold their 53), each part converted, and the parts summed."""
    rest = jax.tree_util.tree_map(lambda v: np.asarray(v, np.float64), tree)
    out = {}
    for _ in range(3):
        part = jax.tree_util.tree_map(lambda v: v.astype(np.float32), rest)
        rest = jax.tree_util.tree_map(lambda v, p: v - p, rest, part)
        for k, v in variables_to_state_dict({"params": part}).items():
            out[k] = out[k] + v.double() if k in out else v.double()
    return out


def _source_target_steps(steps, dtype, jax_conv_mode, calls, size):
    """Run ``steps`` source_target steps of resnettiny from the same init
    in both packages at ``dtype`` on ``size`` x ``size`` batches,
    appending to ``calls`` at each call of the port's kernel-C module;
    yields, after each step, the step
    index, both packages' metrics, the port's model, optimizer and
    parameters before the step, and the JAX parameters before and after
    it and its momentum buffers, as float64 state dicts."""
    jcfg = _step_cfg(jax_default_cfg)
    jcfg.TPU.DENSE_CONV_MODE = jax_conv_mode
    jmodel = jax_build_segmentor(jcfg)
    variables = jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, 64, 64, 3), jnp.float32), train=False)
    variables = jax.tree_util.tree_map(
        lambda v: jnp.asarray(np.asarray(v, np.float32), dtype), variables)
    tx, _ = jax_build_optimizer(jcfg, 1)
    state = state_from_variables(variables, tx)
    jstep = jax.jit(jax_make_train_step(jcfg, jmodel, tx, "source_target"))

    cfg = _step_cfg(get_default_cfg)
    model = build_segmentor(cfg, device="cpu")
    model.load_state_dict(variables_to_state_dict(
        jax.tree_util.tree_map(np.asarray, dict(variables))), strict=True)
    model.to(torch.float64 if dtype == np.float64 else torch.float32)
    model.classifier.dropout.p = 0.0
    model.train()
    optimizer, scheduler, _ = build_optimizer(cfg, model)
    step = make_train_step(cfg, model, optimizer, "source_target")
    conv = model.feature_extractor.backbone.layer4[0].conv2
    assert isinstance(conv, DilatedConv3x3)
    conv.register_forward_hook(lambda *a: calls.append(1))
    for i in range(steps):
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        jbefore = _state_dict64(jax.device_get(state.params))
        b = jax.tree_util.tree_map(
            lambda v: v.astype(dtype) if v.dtype == np.float32 else v,
            _batches(10 + i, size))
        state, jmetrics = jstep(
            state, jax.tree_util.tree_map(jnp.asarray, b),
            jax.random.PRNGKey(i))
        metrics = step({k: {n: torch.from_numpy(v) for n, v in d.items()}
                        for k, d in b.items()})
        scheduler.step()
        assert set(metrics) == set(jmetrics) == {
            "loss_sup", "loss_sup_tgt", "negative_loss", "loss"}
        yield (i, metrics, jmetrics, model, optimizer, before, jbefore,
               _state_dict64(jax.device_get(state.params)),
               _state_dict64(_momentum(state)))


def test_two_source_target_steps_match_jax(jax_pallas, monkeypatch):
    """Step 0 in float32 on 64x64 batches, with the JAX model on kernel
    C's Pallas kernel: loss terms within 1e-5, momentum buffers within
    1e-4 of their max. Steps 0 and 1 in float64 on 32x32 batches (the JAX
    model on XLA's convs, the port on kernel C's plain version; torch's
    float64 CPU convs are slow): loss terms within 1e-12, momentum buffers
    and updates within 1e-10 of their max. Step 1 is held in float64
    only: in float32 the rounding of step 0, carried through a deep random
    trunk into step 1's gradients, reaches ~6e-4 of some buffers' max on
    64x64 batches, while in float64 the two packages agree to ~3e-13
    there."""
    calls = []
    for (i, metrics, jmetrics, model, optimizer, before, jbefore, jafter,
         jtrace) in _source_target_steps(1, np.float32, "pallas", calls, 64):
        for k, v in jmetrics.items():
            np.testing.assert_allclose(float(metrics[k]), float(v),
                                       rtol=1e-5, err_msg=k)
        # The update of a step is -lr * (momentum buffer): compare the
        # buffers, and after - before up to the float32 rounding of
        # storing p + update (a few ulps of p, which exceed 1e-4 of the
        # update where a deep random trunk's gradients are small).
        for n, param in model.named_parameters():
            want = jtrace[n].numpy()
            got = optimizer.state[param]["momentum_buffer"].numpy()
            scale = float(np.abs(want).max())
            assert scale > 0, n
            if n == "classifier.wn_mlp.0.bias":
                # it feeds a train-mode BatchNorm1d: its gradient is 0 in
                # exact arithmetic and float32 noise (~1e-8) in both
                # packages, so the buffer is the weight-decay term alone
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-7,
                                           err_msg=n)
                continue
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale,
                                       err_msg=n)
            want = (jafter[n] - jbefore[n]).numpy()
            got = (param.detach() - before[n]).double().numpy()
            ulp = np.spacing(np.abs(before[n].numpy())).astype(np.float64)
            assert np.all(np.abs(got - want)
                          <= 1e-4 * np.abs(want).max() + 4 * ulp), n
    # the route ran: both forwards of the step went through the module,
    # and its weight got a gradient from the custom backward
    conv = model.feature_extractor.backbone.layer4[0].conv2
    assert len(calls) == 2 and conv.weight.grad is not None

    f64 = _Float32IsFloat64("jax.numpy")
    for module in _F32_CASTING:
        monkeypatch.setattr(module, "jnp", f64)
    monkeypatch.setattr(torch.Tensor, "float",
                        lambda self, *a, **k: self.double(*a, **k))
    # torch's float64 CPU convs (grouped and dilated) take a slow path
    # that gains nothing from threads
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _hold_float64_steps(calls)
    finally:
        torch.set_num_threads(threads)
    assert len(calls) == 2 + 4


def _hold_float64_steps(calls):
    """Steps 0 and 1 in float64 on 32x32 batches, held at 1e-12 (loss
    terms) and 1e-10 of the max (momentum buffers, updates)."""
    for (i, metrics, jmetrics, model, optimizer, before, jbefore, jafter,
         jtrace) in _source_target_steps(2, np.float64, "conv", calls, 32):
        for k, v in jmetrics.items():
            np.testing.assert_allclose(float(metrics[k]), float(v),
                                       rtol=1e-12, err_msg=f"{i} {k}")
        for n, param in model.named_parameters():
            assert param.dtype == torch.float64, n
            want = jtrace[n].numpy()
            got = optimizer.state[param]["momentum_buffer"].numpy()
            np.testing.assert_allclose(
                got, want, rtol=0, atol=1e-10 * float(np.abs(want).max()),
                err_msg=f"step {i} {n}")
            want = (jafter[n] - jbefore[n]).numpy()
            got = (param.detach() - before[n]).numpy()
            np.testing.assert_allclose(
                got, want, rtol=0, atol=1e-10 * float(np.abs(want).max()),
                err_msg=f"step {i} {n}")


def test_head_dropout_drops_whole_channels():
    """The head's Dropout2d is live in train mode: whole channels zeroed at
    rate ~0.1, the rest scaled by 1/0.9 (the JAX head's
    ``nn.Dropout(0.1, broadcast_dims=(1, 2))``); the identity in eval."""
    cfg = _step_cfg(get_default_cfg)
    cfg.TPU.DENSE_CONV_MODE = "conv"
    model = build_segmentor(cfg, device="cpu").train()
    drop = model.classifier.dropout
    torch.manual_seed(0)
    y = drop(torch.ones(16, 512, 3, 5))
    per_channel = y.reshape(16 * 512, 15)
    assert torch.all(per_channel == per_channel[:, :1])
    kept = per_channel[:, 0]
    scale = float(torch.tensor(1 / 0.9, dtype=torch.float32))
    assert set(kept.unique().tolist()) <= {0.0, scale}
    assert abs(float((kept == 0).float().mean()) - 0.1) < 0.02
    model.eval()
    assert torch.equal(drop(torch.ones(2, 512, 3, 5)),
                       torch.ones(2, 512, 3, 5))


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_loads_in_both_packages(tmp_path, monkeypatch):
    for name in ("DENSE_CONV_MODE", "STENCIL_TRAIN", "CONV_WGRAD",
                 "QUANT_EVAL"):
        monkeypatch.setattr(jax_layers, name, getattr(jax_layers, name))
    cfg = _step_cfg(get_default_cfg)
    cfg.TPU.DENSE_CONV_MODE = "conv"
    model = build_segmentor(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(3))
    optimizer, _, _ = build_optimizer(cfg, model)
    path = os.path.join(tmp_path, "last.ckpt")
    save_checkpoint(model, path, optimizer=optimizer, step=7,
                    extra={"active_round": 2})
    blob = torch.load(path, weights_only=False)
    assert set(blob) == {"state_dict", "optimizer", "step", "extra"}
    assert blob["step"] == 7 and blob["extra"] == {"active_round": 2}

    # the port: per-module resume into a fresh model
    other = build_segmentor(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(4))
    load_module_params(other, path, "feature_extractor")
    sd, osd = model.state_dict(), other.state_dict()
    assert all(torch.equal(osd[k], sd[k]) for k in sd
               if k.startswith("feature_extractor."))
    assert not torch.equal(osd["classifier.conv_seg.P_MLR"],
                           sd["classifier.conv_seg.P_MLR"])
    load_module_params(other, path, "classifier")
    assert all(torch.equal(v, sd[k]) for k, v in other.state_dict().items())
    assert load_state_dict_file(path).keys() == sd.keys()

    # the JAX package reads it as a torch checkpoint
    jcfg = _step_cfg(jax_default_cfg)
    jcfg.TPU.DENSE_CONV_MODE = "conv"
    jmodel = jax_build_segmentor(jcfg)
    variables = jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, 64, 64, 3), jnp.float32), train=False)
    tx, _ = jax_build_optimizer(jcfg, 1)
    state = state_from_variables(variables, tx)
    for module in ("feature_extractor", "classifier"):
        state = load_torch_module_params(state, path, module)
    back = variables_to_state_dict(jax.device_get(state.variables()))
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)
