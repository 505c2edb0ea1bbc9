"""Port parity, the test entry point: the rich eval step, ``TestLearner``
and ``python -m halo_tpu_torch.test`` against the JAX package's
counterparts (resnettiny, float32 compute), from the same weights.

Expected: the rich step's probabilities and embedding within 1e-5, >=
99.9% equal predictions, equal IoU histograms, entropy and radius within
1e-5 relative away from the ball's edge (near it artanh magnifies float32
rounding, so there the radius is compared in t = tanh(r/2)); the test
metrics within 1e-3 percentage points, mIoU* at 16 classes, ``.pt``
artifacts with the JAX package's keys, dtypes and shapes (its dtypes
without x64, as it runs on a TPU); the ``TEST.VIZ_WRONG`` panels drawn
from the same image and labels and maps within 1e-5, which the port's
plotting turns into the JAX package's pixels when given its arrays.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from halo_tpu.config import get_default_cfg as jax_default_cfg
from halo_tpu.engine.learners import TestLearner as JaxTestLearner
from halo_tpu.engine.optim import build_optimizer as jax_build_optimizer
from halo_tpu.engine.state import state_from_variables
from halo_tpu.engine.steps import make_rich_eval_step as jax_rich_step
from halo_tpu.models import layers as jax_layers
from halo_tpu.models.build import build_segmentor as jax_build_segmentor
from halo_tpu.utils import visualize as jax_visualize
from halo_tpu_torch import test as port_test
from halo_tpu_torch.config import get_default_cfg
from halo_tpu_torch.engine.learners import TestLearner
from halo_tpu_torch.engine.optim import build_optimizer
from halo_tpu_torch.engine.state import save_checkpoint
from halo_tpu_torch.engine.steps import make_rich_eval_step
from halo_tpu_torch.models import build_segmentor, variables_to_state_dict
from halo_tpu_torch.utils import visualize as port_visualize
from halo_tpu_torch.utils.misc import parse_args
from tests.test_torch_protocols import CONFIGS, record_calls, same_plot

OVERRIDES = {
    "MODEL.NAME": "deeplabv3plus_resnettiny", "MODEL.REDUCED_CHANNELS": 16,
    "INPUT.INPUT_SIZE_TEST": (48, 24), "TPU.COMPUTE_DTYPE": "float32",
    "TPU.LOADER_WORKERS": 0, "MODEL.WEIGHTS": "", "SEED": 47,
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the tensors are tiny, so more threads only add
    overhead, the more so beside the suite's other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def jax_globals(monkeypatch):
    for name in ("DENSE_CONV_MODE", "STENCIL_TRAIN", "CONV_WGRAD",
                 "QUANT_EVAL"):
        monkeypatch.setattr(jax_layers, name, getattr(jax_layers, name))


def test_rich_eval_step_matches_jax(jax_globals):
    jcfg = jax_default_cfg()
    cfg = get_default_cfg()
    for c in (jcfg, cfg):
        c.MODEL.NAME = "deeplabv3plus_resnettiny"
        c.MODEL.REDUCED_CHANNELS = 16
        c.TPU.COMPUTE_DTYPE = "float32"
    jmodel = jax_build_segmentor(jcfg)
    variables = jmodel.init(
        {"params": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)},
        jnp.zeros((1, 64, 64, 3), jnp.float32), train=False)
    variables = jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float32),
                                       variables)
    state = state_from_variables(variables, jax_build_optimizer(jcfg, 1)[0])
    model = build_segmentor(cfg, device="cpu")
    model.load_state_dict(variables_to_state_dict(
        jax.tree_util.tree_map(np.asarray, dict(variables))), strict=True)
    model.eval()

    rng = np.random.default_rng(0)
    img = rng.normal(size=(2, 40, 72, 3)).astype(np.float32)
    label = rng.integers(0, 19, (2, 50, 90)).astype(np.int32)
    label[rng.random(label.shape) < 0.2] = 255
    want = jax.device_get(jax_rich_step(jcfg, jmodel)(
        state, jnp.asarray(img), jnp.asarray(label), flip=True))
    got = make_rich_eval_step(cfg, model)(
        torch.from_numpy(img), torch.from_numpy(label).long(), flip=True)
    got = {k: v.numpy() for k, v in got.items()}
    assert set(got) == set(want)
    for k in ("prob", "embed"):
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    assert got["embed"].shape == (2, 10, 18, 16)
    assert np.mean(got["pred"] == want["pred"]) >= 0.999
    for k in ("inter", "union", "target"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["entropy"], want["entropy"], rtol=1e-5)
    t_got, t_want = np.tanh(got["radius"] / 2), np.tanh(want["radius"] / 2)
    inner = t_want < 0.9
    assert inner.mean() > 0.5
    np.testing.assert_allclose(got["radius"][inner], want["radius"][inner],
                               rtol=1e-5)
    np.testing.assert_allclose(t_got, t_want, rtol=0, atol=1e-6)


def _checkpoint(num_classes, path):
    """A seeded random resnettiny of the port, saved as a checkpoint."""
    cfg = get_default_cfg()
    cfg.MODEL.NAME = "deeplabv3plus_resnettiny"
    cfg.MODEL.REDUCED_CHANNELS = 16
    cfg.MODEL.NUM_CLASSES = num_classes
    model = build_segmentor(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(5))
    save_checkpoint(model, path, optimizer=build_optimizer(cfg, model)[0])
    return path


def _argv(mini_root, out_dir, name, recipe="gtav/test.yaml", **extra):
    items = dict(OVERRIDES, **extra)
    return (["-cfg", os.path.join(CONFIGS, recipe),
             "TPU.DATASET_DIR", str(mini_root), "OUTPUT_DIR", str(out_dir),
             "NAME", name]
            + [str(x) for k, v in items.items() for x in (k, v)])


def _jax_test(argv):
    """The JAX TestLearner on the port's parsed config, without x64."""
    _, pcfg = parse_args(argv)
    jcfg = jax_default_cfg()
    jcfg.set_new_allowed(True)
    jcfg.merge_from_other_cfg(pcfg)
    jcfg.defrost()
    jcfg.TPU.DATA_PARALLEL = 1
    jcfg.SAVE_DIR = pcfg.SAVE_DIR + "_jax"
    with jax.enable_x64(False):
        return jcfg, JaxTestLearner(jcfg).test()


def _same_result(got, want, num_classes):
    assert set(got) == set(want)
    assert ("mIoU*" in got) == (num_classes == 16)
    for k in ("mIoU", "mAcc", "aAcc") + (("mIoU*",) if num_classes == 16
                                         else ()):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-3,
                                   err_msg=k)
    assert len(got["iou_class"]) == num_classes
    np.testing.assert_allclose(got["iou_class"], want["iou_class"], rtol=0,
                               atol=1e-3)


@pytest.mark.parametrize("num_classes,rich", [(19, False), (16, True)])
def test_test_learner_matches_jax(num_classes, rich, mini_root, tmp_path,
                                  jax_globals, capsys):
    recipe = {19: "gtav/test.yaml", 16: "synthia/test.yaml"}[num_classes]
    ckpt = _checkpoint(num_classes, str(tmp_path / "model.ckpt"))
    argv = _argv(mini_root, tmp_path, "port", recipe, resume=ckpt,
                 **{"TEST.SAVE_EMBED": rich})
    jcfg, want = _jax_test(argv)
    _, cfg = parse_args(argv)
    assert cfg.MODEL.NUM_CLASSES == num_classes
    got = TestLearner(cfg, device="cpu").test()
    _same_result(got, want, num_classes)
    names = os.listdir(os.path.join(jcfg.SAVE_DIR, "embed")) if rich else []
    assert sorted(names) == (sorted(os.listdir(os.path.join(
        cfg.SAVE_DIR, "embed"))) if rich else [])
    assert len(names) == (3 if rich else 0)
    for name in names:
        a = torch.load(os.path.join(cfg.SAVE_DIR, "embed", name))
        b = torch.load(os.path.join(jcfg.SAVE_DIR, "embed", name))
        assert {k: (v.dtype, v.shape) for k, v in a.items()} == {
            k: (v.dtype, v.shape) for k, v in b.items()}
        assert a["output"].shape == (1, 32, 64, num_classes)
        assert a["label"].dtype == a["pred"].dtype == torch.int32
        assert torch.equal(a["label"], b["label"])
        assert float((a["pred"] == b["pred"]).float().mean()) >= 0.999
        for k in ("output", "embed"):
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=1e-5)
    out = capsys.readouterr().out
    row = " & ".join(f"{x:.1f}" for x in got["iou_class"])
    assert f"{row} & {got['mIoU']:.1f}" in out


def test_main_matches_jax_with_plots(mini_root, tmp_path, jax_globals,
                                     monkeypatch):
    plots = {side: record_calls(monkeypatch, mod, "visualize_wrong")
             for side, mod in (("jax", jax_visualize),
                               ("port", port_visualize))}
    ckpt = _checkpoint(19, str(tmp_path / "model.ckpt"))
    argv = _argv(mini_root, tmp_path, "port", resume=ckpt,
                 **{"TEST.VIZ_WRONG": True, "TEST.SAVE_EMBED": True})
    jcfg, want = _jax_test(argv)
    got = port_test.main(argv, device="cpu")
    _same_result(got, want, 19)
    save_dir = str(tmp_path / "port")
    wrong = sorted(os.listdir(os.path.join(save_dir, "viz", "wrong")))
    assert wrong == sorted(os.listdir(os.path.join(jcfg.SAVE_DIR, "viz",
                                                   "wrong")))
    assert len(wrong) == len(plots["port"]) == len(plots["jax"]) == 1
    assert len(os.listdir(os.path.join(save_dir, "embed"))) == 3
    for name, got_call, want_call in zip(wrong, plots["port"],
                                         plots["jax"]):
        same_plot(got_call, want_call)
        args, kwargs = want_call
        again = port_visualize.visualize_wrong(
            *args[:6], str(tmp_path / "again.png"), **kwargs)
        pixels = np.asarray(Image.open(again))
        np.testing.assert_array_equal(pixels, np.asarray(Image.open(
            os.path.join(jcfg.SAVE_DIR, "viz", "wrong", name))))
        assert np.asarray(Image.open(os.path.join(
            save_dir, "viz", "wrong", name))).shape == pixels.shape


def test_quant_eval_raises(mini_root, tmp_path):
    _, cfg = parse_args(_argv(mini_root, tmp_path, "q", resume="",
                              **{"TPU.QUANT_EVAL": True}))
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        TestLearner(cfg, device="cpu")


def test_quant_sweep_raises(mini_root, tmp_path):
    """``TPU.QUANT_SWEEP True`` (the int8 sweep) is refused by the active
    learners until int8 is ported, never ignored."""
    from halo_tpu_torch.engine.learners import build_learner
    for recipe in ("gtav/source_target.yaml", "gtav/source_free.yaml"):
        _, cfg = parse_args(_argv(mini_root, tmp_path, "q", recipe,
                                  resume="", **{"TPU.QUANT_SWEEP": True}))
        with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
            build_learner(cfg, device="cpu")


def test_default_weights_need_the_trunk_from_resume(mini_root, tmp_path,
                                                   monkeypatch):
    """The recipe's default ``MODEL.WEIGHTS`` (an ImageNet trunk's URL) is
    loaded from the torch hub cache, never downloaded: not cached, the
    learner raises, ``resume`` or not; cached, the trunk loads, and a
    ``resume`` checkpoint holding the trunk then replaces it whole."""
    from tests.test_torch_checkpoints import torchvision_trunk
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "torch_home"))
    argv = _argv(mini_root, tmp_path, "w", resume="")
    argv = argv[:argv.index("MODEL.WEIGHTS")] + argv[
        argv.index("MODEL.WEIGHTS") + 2:]
    _, cfg = parse_args(argv)
    assert cfg.MODEL.WEIGHTS.startswith("https://")
    ckpt = _checkpoint(19, str(tmp_path / "model.ckpt"))
    for extra in ([], ["resume", ckpt]):
        _, cfg = parse_args(argv + extra)
        with pytest.raises(RuntimeError, match="torch hub cache"):
            TestLearner(cfg, device="cpu")
    cache = tmp_path / "torch_home" / "hub" / "checkpoints"
    cache.mkdir(parents=True)
    trunk = torchvision_trunk(
        str(cache / cfg.MODEL.WEIGHTS.rsplit("/", 1)[-1]))
    _, cfg = parse_args(argv)
    learner = TestLearner(cfg, device="cpu")
    got = learner.model.feature_extractor.backbone.state_dict()
    assert all(torch.equal(got[k], trunk[k]) for k in got)
    _, cfg = parse_args(argv + ["resume", ckpt])
    learner = TestLearner(cfg, device="cpu")
    want = torch.load(ckpt, weights_only=False)["state_dict"]
    assert all(torch.equal(v, want[k])
               for k, v in learner.model.state_dict().items())
