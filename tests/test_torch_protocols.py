"""Port parity, the training protocols: ``source``, ``source_free`` and
``fully_sup`` through ``halo_tpu_torch.train.main`` against the JAX
package's learners (resnettiny on the mini dataset, ``TPU.DATA_PARALLEL
1``), from the same weights (the JAX init, handed to the port through
``resume``), with dropout the identity in both; protocol dispatch; the
SYNTHIA set; and ``resume_full`` after a SIGTERM.

Expected: per-step loss terms within 1e-5 relative over 2 steps (float32
compute; the JAX model runs XLA's convs, the port kernel C's plain version,
so sums differ in order only), byte-identical round-1 mask PNGs and
indicators for ``source_free``, and its ``ACTIVE.VIZ_MASK`` plot drawn
from the same image and mask and a score map within 1e-5 (float32
summation order), which the port's plotting turns into the JAX package's
pixels when given the JAX package's arrays. The
negative-learning threshold sits above every probability, as
``tests/test_torch_train.py:_step_cfg`` explains; ``fully_sup`` runs with
LCR on.
"""

import os
import pickle
import signal

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch
from PIL import Image

from halo_tpu.config import get_default_cfg as jax_default_cfg
from halo_tpu.data.build import build_dataset as jax_build_dataset
from halo_tpu.engine import build_learner as jax_build_learner
from halo_tpu.models import layers as jax_layers
from halo_tpu.utils import visualize as jax_visualize
from halo_tpu_torch import train
from halo_tpu_torch.data import mask_cache
from halo_tpu_torch.data.build import build_dataset
from halo_tpu_torch.data.datasets import ID_TO_TRAINID_16
from halo_tpu_torch.engine import learners as port_learners
from halo_tpu_torch.models import variables_to_state_dict
from halo_tpu_torch.utils import visualize as port_visualize
from halo_tpu_torch.utils.misc import parse_args

CONFIGS = os.path.join(os.path.dirname(__file__), os.pardir, "configs")
RECIPES = {"source": "gtav/source_only.yaml",
           "source_free": "gtav/source_free.yaml",
           "source_target": "gtav/source_target.yaml",
           "fully_sup": "gtav/fully_sup.yaml",
           "test": "gtav/test.yaml"}
# SEED 47: the round's and the test's 20 plotted indices include image 0.
OVERRIDES = {
    "MODEL.NAME": "deeplabv3plus_resnettiny", "MODEL.REDUCED_CHANNELS": 16,
    "INPUT.SOURCE_INPUT_SIZE_TRAIN": (48, 24),
    "INPUT.TARGET_INPUT_SIZE_TRAIN": (48, 24),
    "INPUT.INPUT_SIZE_TEST": (48, 24),
    "SOLVER.NUM_ITER": 2, "SOLVER.WARMUP_ITERS": 0, "SOLVER.BASE_LR": 0.005,
    "SOLVER.NEGATIVE_THRESHOLD": 0.2, "SOLVER.CONSISTENT_LOSS": 0.5,
    "ACTIVE.SELECT_ITER": [0], "ACTIVE.MASK_RADIUS_K": 2,
    "ACTIVE.VIZ_MASK": True, "DATASETS.TEST": "cityscapes_val",
    "TPU.COMPUTE_DTYPE": "float32", "TPU.SCORING_DTYPE": "float32",
    "TPU.VAL_INTERVAL": 0, "TPU.LOADER_WORKERS": 0, "SEED": 47,
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the tensors are tiny, so more threads only add
    overhead, the more so beside the suite's other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _files(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for dirpath, _dirs, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _png(path):
    return np.asarray(Image.open(path))


def _argv(protocol, mini_root, out_dir, name, **extra):
    argv = ["-cfg", os.path.join(CONFIGS, RECIPES[protocol]),
            "TPU.DENSE_CONV_MODE", "pallas", "MODEL.WEIGHTS", "",
            "resume", "", "TPU.DATASET_DIR", str(mini_root),
            "OUTPUT_DIR", str(out_dir), "NAME", name]
    items = dict(OVERRIDES, **extra)
    return argv + [str(x) for k, v in items.items() for x in (k, v)]


def _jax_cfg(protocol, mini_root, save_dir):
    cfg = jax_default_cfg()
    cfg.set_new_allowed(True)
    cfg.merge_from_file(os.path.join(CONFIGS, RECIPES[protocol]))
    for key, value in OVERRIDES.items():
        node, leaf = key.rsplit(".", 1) if "." in key else ("", key)
        setattr(cfg.get(node) if node else cfg, leaf, value)
    cfg.MODEL.WEIGHTS = ""
    cfg.resume = ""
    cfg.TPU.DATA_PARALLEL = 1
    cfg.TPU.DATASET_DIR = str(mini_root)
    cfg.SAVE_DIR = str(save_dir)
    return cfg


@pytest.fixture
def no_dropout(monkeypatch):
    """Dropout the identity in both packages; the JAX package's conv
    globals restored afterwards."""
    for name in ("DENSE_CONV_MODE", "STENCIL_TRAIN", "CONV_WGRAD",
                 "QUANT_EVAL"):
        monkeypatch.setattr(jax_layers, name, getattr(jax_layers, name))
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, inputs, *a, **k: inputs)
    monkeypatch.setattr(torch.nn.Dropout2d, "forward", lambda self, x: x)


def record_calls(monkeypatch, module, name):
    """Wrap ``module.name`` so that each call's arguments are recorded;
    returns the list of (args, kwargs)."""
    calls = []
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        calls.append((args, kwargs))
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapped)
    return calls


def same_plot(got, want):
    """Two recorded calls of one plotting function: the same image, labels
    and options, float maps within 1e-5 of their max."""
    (gargs, gkw), (wargs, wkw) = got, want
    assert gkw == wkw and len(gargs) == len(wargs)
    for a, b in zip(gargs, wargs):
        if isinstance(b, np.ndarray) and b.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-5 * np.abs(b).max())
        elif isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("protocol", ["source", "source_free", "fully_sup"])
def test_two_steps_match_jax(protocol, mini_root, tmp_path, no_dropout,
                             monkeypatch):
    plots = {side: record_calls(monkeypatch, mod, "visualization_plots")
             for side, mod in (("jax", jax_visualize),
                               ("port", port_visualize))}
    jcfg = _jax_cfg(protocol, mini_root, tmp_path / "jax")
    learner = jax_build_learner(jcfg)
    init = os.path.join(tmp_path, "init.ckpt")
    torch.save({"state_dict": variables_to_state_dict(jax.tree_util.tree_map(
        np.asarray, learner.state.variables()))}, init)
    jhist = learner.fit(val_interval=0)

    mask_cache.clear()
    port = train.main(_argv(protocol, mini_root, tmp_path, "port",
                            resume=init), device="cpu")
    assert type(port).__name__ == type(learner).__name__
    assert port.protocol == protocol
    assert len(jhist) == len(port.history) == 2
    terms = {"source": {"loss_sup"},
             "source_free": {"loss_sup_tgt", "negative_loss"},
             "fully_sup": {"loss_sup", "consistency_loss", "loss_sup_tgt",
                           "negative_loss"}}[protocol] | {"loss"}
    for got, want in zip(port.history, jhist):
        assert set(got) == set(want)
        assert terms <= set(got)
        for k in terms:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       err_msg=f"step {got['step']} {k}")
        assert got["active_round"] == want["active_round"]
    save_dir = str(tmp_path / "port")
    for sub in ("gtMask", "gtIndicator"):
        got = _files(os.path.join(save_dir, sub))
        want = _files(os.path.join(jcfg.SAVE_DIR, sub))
        if protocol == "source":
            assert got == want == {}
            continue
        # fully_sup: the initial 255-masks; source_free: round 1's
        assert got == want and len(got) == 3, sub
    labeled = sum(int((_png(os.path.join(save_dir, "gtMask", "train", n))
                       != 255).sum())
                  for n in _files(os.path.join(save_dir, "gtMask", "train")))
    assert (labeled > 0) == (protocol == "source_free")
    viz = sorted(_files(os.path.join(save_dir, "viz")))
    assert viz == sorted(_files(os.path.join(jcfg.SAVE_DIR, "viz")))
    assert len(viz) == len(plots["port"]) == len(plots["jax"]) == (
        1 if protocol == "source_free" else 0)
    for name, got, want in zip(viz, plots["port"], plots["jax"]):
        same_plot(got, want)
        # the port's plot of the JAX package's arrays: the JAX pixels
        args, kwargs = want
        again = port_visualize.visualization_plots(
            *args[:5], str(tmp_path / "again"), **kwargs)
        np.testing.assert_array_equal(
            _png(again), _png(os.path.join(jcfg.SAVE_DIR, "viz", name)))
        assert (_png(os.path.join(save_dir, "viz", name)).shape
                == _png(again).shape)
    assert os.path.exists(os.path.join(save_dir, "last.ckpt"))


@pytest.mark.parametrize("protocol", ["source_target", "source_free"])
def test_quant_sweep_round_matches_jax(protocol, mini_root, tmp_path,
                                       no_dropout, capsys):
    """``TPU.QUANT_SWEEP``: round 1 at step 0 sweeps with an int8 twin of
    the model, calibrated on the round's first sweep batches, in both
    packages from the same weights. The twin's calibration is the JAX
    twin's (amax within 4e-6 relative, int8 weights and scales equal, as
    tests/test_torch_quant.py holds them), the training model stays float,
    and the round labels as many pixels an image as the JAX round with
    >= 90% of them shared. Not byte-identical masks: an int8 activation
    whose input sits on a rounding boundary rounds the other way in one
    package and moves the logits by ~0.25% (test_torch_quant.py), enough
    to move a greedy pick (measured: one 9-pixel region of the 3 images'
    ~300 labelled pixels, source_target)."""
    from halo_tpu_torch.models.convert import quant_tree_to_state
    from halo_tpu_torch.ops import quant
    extra = {"TPU.QUANT_SWEEP": True, "SOLVER.NUM_ITER": 1,
             "ACTIVE.VIZ_MASK": False}
    jcfg = _jax_cfg(protocol, mini_root, tmp_path / "jax")
    for key, value in extra.items():
        node, leaf = key.rsplit(".", 1)
        setattr(jcfg.get(node), leaf, value)
    learner = jax_build_learner(jcfg)
    init = os.path.join(tmp_path, "init.ckpt")
    torch.save({"state_dict": variables_to_state_dict(jax.tree_util.tree_map(
        np.asarray, learner.state.variables()))}, init)
    # the JAX twin's calibration at step 0, as the round computes it
    want = quant_tree_to_state(jax.tree_util.tree_map(
        np.asarray, learner._sweep_model_state()[1].quant))
    learner.fit(val_interval=0)

    mask_cache.clear()
    port = train.main(_argv(protocol, mini_root, tmp_path, "port",
                            resume=init, **extra), device="cpu")
    assert port.protocol == protocol and port.active_round == 2
    assert not quant.quant_layers(port.model)
    quant.assert_calibrated(port.quant_twin)
    got = quant.quant_state(port.quant_twin)
    assert got.keys() == want.keys()
    for layer in got:
        assert torch.equal(got[layer]["w_int8"], want[layer]["w_int8"])
        assert torch.equal(got[layer]["w_scale"], want[layer]["w_scale"])
        np.testing.assert_allclose(got[layer]["amax"], want[layer]["amax"],
                                   rtol=4e-6, err_msg=layer)
    masks = os.path.join("gtMask", "train")
    names = sorted(_files(os.path.join(jcfg.SAVE_DIR, masks)))
    assert names == sorted(_files(os.path.join(tmp_path, "port", masks)))
    assert len(names) == 3
    for name in names:
        a = _png(os.path.join(tmp_path, "port", masks, name)) != 255
        b = _png(os.path.join(jcfg.SAVE_DIR, masks, name)) != 255
        print(f"{name}: {int(a.sum())} labelled pixels (JAX {int(b.sum())}),"
              f" {int((a & b).sum())} shared")
        assert a.sum() == b.sum() > 0 and (a & b).sum() >= 0.9 * b.sum()


@pytest.mark.parametrize("protocol", sorted(RECIPES))
def test_build_learner_dispatches(protocol, mini_root, tmp_path):
    _, cfg = parse_args(_argv(protocol, mini_root, tmp_path, protocol,
                              PROTOCOL=protocol))
    learner = port_learners.build_learner(cfg, device="cpu")
    assert isinstance(learner, port_learners.PROTOCOLS[protocol])
    assert learner.protocol == protocol
    assert hasattr(learner, "active_loader") == (
        protocol in ("source_free", "source_target"))
    if protocol != "test":
        assert set(learner.train_loaders()) == {
            "source": {"source"}, "source_free": {"target"},
            "source_target": {"source", "target"},
            "fully_sup": {"source", "target"}}[protocol]


@pytest.mark.parametrize("name", ["source_only", "source_free",
                                  "source_target", "fully_sup", "test"])
def test_synthia_recipes_load(name, tmp_path):
    """configs/synthia/*.yaml load in the port at 16 classes, and their
    protocol has a learner."""
    _, cfg = parse_args(["-cfg", os.path.join(CONFIGS, "synthia",
                                              name + ".yaml"),
                         "OUTPUT_DIR", str(tmp_path)])
    assert cfg.MODEL.NUM_CLASSES == 16
    protocol = "test" if name == "test" else cfg.PROTOCOL
    assert protocol in port_learners.PROTOCOLS
    assert cfg.DATASETS.SOURCE_TRAIN in ("", "synthia_train",
                                         "cityscapes_train")


def test_unknown_protocol_raises(mini_root, tmp_path):
    _, cfg = parse_args(_argv("source", mini_root, tmp_path, "x",
                              PROTOCOL="semi"))
    with pytest.raises(NotImplementedError, match="semi"):
        port_learners.build_learner(cfg, device="cpu")


def _synthia_tree(root):
    """Four SYNTHIA images: two with single-channel 16-bit label PNGs, two
    with the id in channel 0 of an RGB label; and the label-info pickle."""
    rng = np.random.default_rng(5)
    ids = np.array(list(ID_TO_TRAINID_16) + [0, 3], np.uint16)
    syn = root / "synthia"
    (syn / "images").mkdir(parents=True)
    (syn / "GT" / "LABELS").mkdir(parents=True)
    names = []
    for i in range(4):
        name = f"{i:07d}.png"
        Image.fromarray(rng.integers(0, 255, (38, 64, 3), np.uint8)).save(
            syn / "images" / name)
        lab = rng.choice(ids, (38, 64))
        if i < 2:
            label = Image.fromarray(lab)
            assert label.mode.startswith("I;16")
        else:
            rgb = np.stack([lab, rng.integers(0, 255, lab.shape),
                            np.zeros_like(lab)], -1).astype(np.uint8)
            label = Image.fromarray(rgb)
        label.save(syn / "GT" / "LABELS" / name)
        names.append(name)
    (root / "synthia_train_list.txt").write_text("\n".join(names) + "\n")
    with open(syn / "synthia_label_info.p", "wb") as f:
        pickle.dump(([names[c % 4:c % 4 + 2] for c in range(16)],
                     {n: [i, i + 4] for i, n in enumerate(names)}), f)


def test_synthia_dataset_matches_jax(tmp_path):
    _synthia_tree(tmp_path)
    _, pcfg = parse_args(["-cfg", os.path.join(
        CONFIGS, "synthia/source_only.yaml"), "TPU.DATASET_DIR",
        str(tmp_path), "OUTPUT_DIR", str(tmp_path), "SOLVER.NUM_ITER", "5",
        "INPUT.SOURCE_INPUT_SIZE_TRAIN", "(40, 24)", "SEED", "3"])
    jcfg = jax_default_cfg()
    jcfg.set_new_allowed(True)
    jcfg.merge_from_other_cfg(pcfg)
    assert pcfg.MODEL.NUM_CLASSES == 16
    want = jax_build_dataset(jcfg, "train", is_source=True)
    got = build_dataset(pcfg, "train", is_source=True)
    assert type(got).__name__ == type(want).__name__ == "SynthiaDataSet"
    assert [e["name"] for e in got.data_list] == [
        e["name"] for e in want.data_list]
    assert len(got) == 3000  # one sub-epoch of the balanced draw
    for i in range(4):
        a = got.__getitem__(i, rng=None)
        b = want.__getitem__(i, rng=None)
        np.testing.assert_array_equal(a["img"], b["img"])
        np.testing.assert_array_equal(a["label"], b["label"])
        assert a["label"].max() == 255 and a["label"].min() < 16
    # the id of a 16-bit label comes through unchanged before the remap
    raw = got._read_label(got.data_list[0]["label"])
    np.testing.assert_array_equal(
        raw, np.asarray(Image.open(got.data_list[0]["label"])))


def test_resume_full_after_sigterm(mini_root, tmp_path):
    """SIGTERM inside step 1: the step finishes, preempt.ckpt holds step 2;
    a fresh learner's resume_full restores step, LR, momentum buffers and
    counters exactly and the run ends at NUM_ITER without rewriting
    round 1's checkpoint."""
    _, cfg = parse_args(_argv("source_free", mini_root, tmp_path, "run",
                              **{"SOLVER.NUM_ITER": 4,
                                 "ACTIVE.SELECT_ITER": [0, 2],
                                 "ACTIVE.VIZ_MASK": False}))
    mask_cache.clear()
    learner = port_learners.build_learner(cfg, device="cpu")
    step_fn = learner.train_step

    def step_and_signal(batches):
        out = step_fn(batches)
        if learner.step == 1:
            # never let the default action end the test process
            assert signal.getsignal(signal.SIGTERM) not in (
                signal.SIG_DFL, signal.SIG_IGN, None)
            signal.raise_signal(signal.SIGTERM)
        return out

    learner.train_step = step_and_signal
    before = signal.getsignal(signal.SIGTERM)
    learner.fit(val_interval=1)
    assert signal.getsignal(signal.SIGTERM) is before
    assert [r["step"] for r in learner.history] == [0, 1]
    assert learner.step == 2 and learner.active_round == 2
    assert learner.best_miou >= 0
    path = os.path.join(cfg.SAVE_DIR, "preempt.ckpt")
    round1 = os.path.join(cfg.SAVE_DIR, "model_before_round_1.ckpt")
    with open(round1, "rb") as f:
        round1_bytes = f.read()
    assert not os.path.exists(os.path.join(
        cfg.SAVE_DIR, "model_before_round_2.ckpt"))

    fresh = port_learners.build_learner(cfg, device="cpu")
    assert fresh.resume_full(path) == 2
    assert fresh.step == 2 and fresh.active_round == 2
    assert fresh.best_miou == learner.best_miou
    assert fresh.scheduler.last_epoch == learner.scheduler.last_epoch == 2
    assert ([g["lr"] for g in fresh.optimizer.param_groups]
            == [g["lr"] for g in learner.optimizer.param_groups]
            == [fresh._lr_at(2)["lr_fea"], fresh._lr_at(2)["lr_cls"]])
    for (n, p), q in zip(learner.model.named_parameters(),
                         fresh.model.parameters()):
        assert torch.equal(p, q), n
        assert torch.equal(learner.optimizer.state[p]["momentum_buffer"],
                           fresh.optimizer.state[q]["momentum_buffer"]), n
    fresh.fit(val_interval=1)
    assert [r["step"] for r in fresh.history] == [2, 3]
    assert [r["active_round"] for r in fresh.history] == [3, 3]
    assert fresh.step == cfg.SOLVER.NUM_ITER
    assert torch.load(os.path.join(cfg.SAVE_DIR, "last.ckpt"),
                      weights_only=False)["step"] == cfg.SOLVER.NUM_ITER
    assert os.path.exists(os.path.join(cfg.SAVE_DIR,
                                       "model_before_round_2.ckpt"))
    with open(round1, "rb") as f:
        assert f.read() == round1_bytes
