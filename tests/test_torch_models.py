"""Port parity, models: JAX weights carried into the port with
variables_to_state_dict, then the same input through both
deeplabv3plus_resnettiny hyper models (COMPUTE_DTYPE float32, eval).
Tolerances: logits atol 1e-4 (oneDNN against XLA conv summation order),
ball embedding 1e-5, argmax agreement >= 99.9%."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo_tpu.config import get_default_cfg as jax_default_cfg
from halo_tpu.models.build import build_segmentor as jax_build
from halo_tpu.models.port_torch import torch_state_dict_to_variables
from halo_tpu_torch.config import get_default_cfg
from halo_tpu_torch.engine import make_forward
from halo_tpu_torch.models import build_segmentor, variables_to_state_dict


def _cfg(make, freeze_bn):
    cfg = make()
    cfg.MODEL.NAME = "deeplabv3plus_resnettiny"
    cfg.MODEL.REDUCED_CHANNELS = 16
    cfg.MODEL.FREEZE_BN = freeze_bn
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _shapes(tree):
    return {jax.tree_util.keystr(p): tuple(v.shape)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@functools.lru_cache(maxsize=None)
def _weights(freeze_bn):
    """Seeded port weights with non-trivial BN statistics, carried into the
    JAX tree by the JAX package's own importer."""
    model = build_segmentor(_cfg(get_default_cfg, freeze_bn), device="cpu",
                            generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    sd = {}
    for k, v in model.state_dict().items():
        if k.endswith("running_var"):
            v = torch.rand(v.shape, generator=gen) + 0.5
        elif v.is_floating_point() and "running" in k or k.endswith(
                ("bn1.weight", "bn1.bias")):
            v = v + 0.1 * torch.randn(v.shape, generator=gen)
        sd[k] = v
    numpy_sd = {k: v.numpy() for k, v in sd.items()}
    variables = {"params": {}, "frozen": {}, "batch_stats": {}}
    for module in ("feature_extractor", "classifier"):
        part = torch_state_dict_to_variables(numpy_sd, module,
                                             freeze_bn=freeze_bn)
        for col in variables:
            if part[col]:
                variables[col][module] = part[col]
    return freeze_bn, sd, {k: v for k, v in variables.items() if v}


@pytest.mark.parametrize("freeze_bn", [True, False],
                         ids=["frozen_bn", "live_bn"])
def test_state_dict_round_trip(freeze_bn):
    """variables_to_state_dict inverts port_torch's name maps, both ways:
    the JAX tree has the JAX model's own structure and shapes, converts to
    the port's state_dict bit for bit, and carries back unchanged."""
    freeze_bn, sd, variables = _weights(freeze_bn)
    model = jax_build(_cfg(jax_default_cfg, freeze_bn))
    shapes = jax.eval_shape(lambda x: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        x, train=False), jnp.zeros((1, 64, 128, 3), jnp.float32))
    assert _shapes(variables) == _shapes(dict(shapes))

    back = variables_to_state_dict(variables)
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k].to(sd[k].dtype), sd[k]), k
    numpy_sd = {k: v.numpy() for k, v in back.items()}
    for module in ("feature_extractor", "classifier"):
        again = torch_state_dict_to_variables(numpy_sd, module,
                                              freeze_bn=freeze_bn)
        for col in ("params", "frozen", "batch_stats"):
            got, exp = (_leaves(again[col]),
                        _leaves(variables.get(col, {}).get(module, {})))
            assert got.keys() == exp.keys(), (module, col)
            for k in exp:
                np.testing.assert_array_equal(got[k], exp[k], err_msg=k)


def test_forward_matches_jax():
    """The recipe's frozen-BN model; the live-BN naming is covered by the
    round trip above."""
    freeze_bn, _, variables = _weights(True)
    x = np.random.default_rng(0).normal(size=(2, 64, 128, 3)).astype(
        np.float32)
    jmodel = jax_build(_cfg(jax_default_cfg, freeze_bn))
    logits, embed = jax.jit(lambda v, x: jmodel.apply(
        v, x, size=(64, 128), train=False))(variables, jnp.asarray(x))
    logits, embed = np.asarray(logits), np.asarray(embed)

    model = build_segmentor(_cfg(get_default_cfg, freeze_bn), device="cpu")
    model.load_state_dict(variables_to_state_dict(variables), strict=True)
    with torch.no_grad():
        t_logits, t_embed = make_forward(model)(torch.from_numpy(x))
    assert t_logits.shape == logits.shape and t_embed.shape == embed.shape
    np.testing.assert_allclose(t_logits.numpy(), logits, rtol=0, atol=1e-4)
    np.testing.assert_allclose(t_embed.numpy(), embed, rtol=0, atol=1e-5)
    agree = (t_logits.numpy().argmax(-1) == logits.argmax(-1)).mean()
    assert agree >= 0.999


def test_build_rejects_unported_models():
    """The port builds what the JAX package's build_segmentor builds and
    refuses what it refuses, with its message; the one deliberate
    difference: a SegFormer head on a ResNet trunk, which the JAX package
    builds and fails to apply, is refused when the port builds it
    (ValueError naming the stage maps c1..c4 it lacks)."""
    builds = ("segformer_mitb4", "deeplabv3plus_mitb2")
    refused = {"segformer_mit_b5": "Unsupported backbone",
               "deeplabv3plus_resnet18": "Unsupported backbone",
               "pspnet_resnettiny": "Unsupported classifier"}
    for name in builds + ("segformer_resnet101",) + tuple(refused):
        jcfg = jax_default_cfg()
        jcfg.MODEL.NAME = name
        if name in refused:
            with pytest.raises(NotImplementedError, match=refused[name]):
                jax_build(jcfg)
        else:
            jax_build(jcfg)
    cfg = get_default_cfg()
    for name in builds:
        cfg.MODEL.NAME = name
        with torch.device("meta"):
            model = build_segmentor(cfg, device="meta")
        assert model.feature_extractor.channels["out"] == 512
    for name, message in refused.items():
        cfg.MODEL.NAME = name
        with pytest.raises(NotImplementedError, match=message):
            build_segmentor(cfg, device="cpu")
    cfg.MODEL.NAME = "segformer_resnet101"
    with pytest.raises(ValueError, match="c1..c4"):
        build_segmentor(cfg, device="cpu")
