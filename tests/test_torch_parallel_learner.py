"""Port parity, the data-parallel slice as a whole: ``train.main`` on 2
gloo ranks against the JAX learner with ``TPU.DATA_PARALLEL 2`` on the
8-device CPU mesh (same converted init, dropout the identity in both):
round 1's masks and indicators byte for byte, the losses of 2 steps within
``tests/test_torch_learner.py``'s 1e-4, the validation mIoU, one
``metrics.jsonl`` and rank 0's checkpoints, bit-identical parameters on
the ranks; the ``random`` arm's round on 2 ranks against the JAX
package's; SIGTERM to one rank (both stop at one poll step, one
``preempt.ckpt``, ``resume_full`` continues); the test entry on 2 ranks
against one process.

Rank processes start through ``tests/torch_parallel_worker.py`` (a
``file://`` rendezvous, one torch thread, every run joined with a
timeout)."""

import json
import os
import signal
import time

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

import halo_tpu.active.region_selection as jax_rs
from halo_tpu.active.region_selection import region_selection as jax_round
from halo_tpu.config import get_default_cfg as jax_default_cfg
from halo_tpu.engine import build_learner as jax_build_learner
from halo_tpu.models import layers as jax_layers
from halo_tpu_torch import test as port_test
from halo_tpu_torch.config import get_default_cfg
from halo_tpu_torch.data.masks import load_indicator
from halo_tpu_torch.models import variables_to_state_dict
from halo_tpu_torch.parallel.launch import TORCHRUN_VARS
from tests.conftest import add_mixed_size_images, build_mini_dataset
from tests.test_engine import tiny_cfg
from tests.torch_parallel_worker import run_ranks

CONFIGS = os.path.join(os.path.dirname(__file__), os.pardir, "configs")
CONFIG = os.path.join(CONFIGS, "gtav", "source_target.yaml")
OVERRIDES = {
    "MODEL.NAME": "deeplabv3plus_resnettiny", "MODEL.REDUCED_CHANNELS": 16,
    "INPUT.SOURCE_INPUT_SIZE_TRAIN": (48, 24),
    "INPUT.TARGET_INPUT_SIZE_TRAIN": (48, 24),
    "INPUT.INPUT_SIZE_TEST": (48, 24),
    "SOLVER.NUM_ITER": 4, "SOLVER.WARMUP_ITERS": 2, "SOLVER.BASE_LR": 0.005,
    "SOLVER.CONSISTENT_LOSS": 0.2,
    "ACTIVE.SELECT_ITER": [0], "ACTIVE.MASK_RADIUS_K": 2,
    "TPU.ACTIVE_BATCH": 1, "TPU.COMPUTE_DTYPE": "float32",
    "TPU.SCORING_DTYPE": "float32", "TPU.VAL_INTERVAL": 2,
    "TPU.LOADER_WORKERS": 0, "SEED": 1,
}


@pytest.fixture(autouse=True)
def no_torchrun(monkeypatch):
    for name in TORCHRUN_VARS:
        monkeypatch.delenv(name, raising=False)


def _argv(cfg_path, root, out_dir, name, overrides, **extra):
    argv = ["-cfg", cfg_path, "TPU.DENSE_CONV_MODE", "pallas",
            "MODEL.WEIGHTS", "", "TPU.DATASET_DIR", str(root),
            "OUTPUT_DIR", str(out_dir), "NAME", name]
    items = dict(overrides, **extra)
    return argv + [str(x) for k, v in items.items() for x in (k, v)]


def _files(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for dirpath, _dirs, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _jsonl(save_dir):
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _same_indicators(a_dir, b_dir):
    a_files = _files(a_dir)
    assert a_files.keys() == _files(b_dir).keys() and a_files
    for rel in a_files:
        a = load_indicator(os.path.join(a_dir, rel))
        b = load_indicator(os.path.join(b_dir, rel))
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=rel)


def test_source_target_two_ranks_matches_jax(mini_root, tmp_path,
                                             monkeypatch):
    for name in ("DENSE_CONV_MODE", "STENCIL_TRAIN", "CONV_WGRAD",
                 "QUANT_EVAL"):
        monkeypatch.setattr(jax_layers, name, getattr(jax_layers, name))
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, inputs, *a, **k: inputs)
    jax_rounds = []

    def snapshot(cfg, *args, **kwargs):
        stats = run_round(cfg, *args, **kwargs)
        jax_rounds.append((stats, _files(os.path.join(cfg.SAVE_DIR,
                                                      "gtMask"))))
        return stats

    run_round = jax_rs.region_selection
    monkeypatch.setattr(jax_rs, "region_selection", snapshot)

    jcfg = jax_default_cfg()
    jcfg.set_new_allowed(True)
    jcfg.merge_from_file(CONFIG)
    for key, value in OVERRIDES.items():
        node, leaf = key.rsplit(".", 1) if "." in key else ("", key)
        setattr(jcfg.get(node) if node else jcfg, leaf, value)
    jcfg.MODEL.WEIGHTS = ""
    jcfg.resume = ""
    jcfg.TPU.DATA_PARALLEL = 2
    jcfg.TPU.DATASET_DIR = str(mini_root)
    jcfg.SAVE_DIR = str(tmp_path / "jax")
    learner = jax_build_learner(jcfg)
    assert learner.num_devices == 2
    init = os.path.join(tmp_path, "init.ckpt")
    torch.save({"state_dict": variables_to_state_dict(jax.tree_util.tree_map(
        np.asarray, learner.state.variables()))}, init)
    jhist = learner.fit(val_interval=2)

    argv = _argv(CONFIG, mini_root, tmp_path, "port", OVERRIDES,
                 resume=init)
    outs = run_ranks("train", 2, tmp_path / "ranks",
                     args={"argv": argv, "no_dropout": True}, timeout=240)
    save_dir = str(tmp_path / "port")

    # the run: N = 2, 2 steps of global batches of 4 (2 a rank)
    for out in outs:
        assert out["num_devices"] == 2 and out["step"] == 2
        assert out["batch_sizes"] == [2] * 4   # source and target
    # round 1 (at step 0): the summed counts and the masks of both ranks,
    # byte for byte as the JAX learner's
    (jstats, jmasks), = jax_rounds
    for out in outs:
        (stats, _), = out["rounds"]
        assert stats == {k: int(v) for k, v in jstats.items()}
    masks = outs[0]["rounds"][0][1]
    got = {k.split(os.sep, 1)[1]: v for k, v in masks.items()
           if k.startswith("gtMask")}
    assert got == jmasks and len(got) == 3
    _same_indicators(os.path.join(jcfg.SAVE_DIR, "gtIndicator"),
                     os.path.join(save_dir, "gtIndicator"))
    # losses within 1e-4 of the JAX learner's, the same on both ranks
    assert outs[0]["history"] == outs[1]["history"]
    assert len(jhist) == len(outs[0]["history"]) == 2
    for got, want in zip(outs[0]["history"], jhist):
        assert set(got) == set(want)
        assert got["active_round"] == want["active_round"]
        for k in ("loss", "loss_sup", "loss_sup_tgt", "negative_loss",
                  "consistency_loss"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       err_msg=f"step {got['step']} {k}")
        for k in ("lr_fea", "lr_cls"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
    # one metrics.jsonl (rank 0's), the validation mIoU equal on the
    # ranks and to the JAX learner's
    recs = _jsonl(save_dir)
    assert [r["step"] for r in recs if "step" in r] == [0, 1]
    miou = [r["mIoU"] for r in recs if "mIoU" in r]
    jmiou = [r["mIoU"] for r in _jsonl(jcfg.SAVE_DIR) if "mIoU" in r]
    assert len(miou) == len(jmiou) == 1
    assert outs[0]["best_miou"] == outs[1]["best_miou"] == miou[0]
    np.testing.assert_allclose(miou[0], jmiou[0], rtol=1e-6)
    # rank 0 alone wrote the checkpoints; bit-identical parameters
    assert outs[0]["saved"] == ["model_before_round_1.ckpt",
                                "best_mIoU.ckpt", "last.ckpt"]
    assert outs[1]["saved"] == []
    assert outs[0]["params"] == outs[1]["params"]
    state = torch.load(os.path.join(save_dir, "last.ckpt"),
                       weights_only=False)["state_dict"]
    assert not any(k.startswith("module.") for k in state)


def test_random_round_two_ranks_matches_jax(tmp_path):
    """The ``random`` arm over a target set of two native sizes (three
    32x64 images, then two 40x72) at ``TPU.ACTIVE_BATCH`` 1 on 2 ranks:
    the global batches of 2 (the 32x64 bucket's last one padded) put the
    40x72 images at indices 4 and 5 of the sweep, on ranks 0 and 1; the
    masks, seeded by that index, are the JAX package's under
    ``TPU.DATA_PARALLEL 2``."""
    root = build_mini_dataset(tmp_path / "datasets")
    add_mixed_size_images(root)
    cfg = tiny_cfg(root, tmp_path, "source_target", devices=2)
    cfg.ACTIVE.UNCERTAINTY = "random"
    cfg.TPU.ACTIVE_BATCH = 1
    cfg.SEED = 5
    learner = jax_build_learner(cfg)
    assert learner.num_devices == 2
    want = jax_round(cfg, learner.model, learner.state,
                     learner.active_loader, 1, mesh=learner.mesh)

    pcfg = get_default_cfg()
    pcfg.set_new_allowed(True)
    pcfg.merge_from_other_cfg(cfg)
    pcfg.SAVE_DIR = str(tmp_path / "port")
    work = tmp_path / "ranks"
    work.mkdir()
    (work / "cfg.yaml").write_text(pcfg.dump())
    outs = run_ranks("random_round", 2, work, args={"round": 1})
    assert outs[0]["positions"] == [[0], [2], [4]]
    assert outs[1]["positions"] == [[1], [5]]
    for out in outs:
        assert out["stats"] == {k: int(v) for k, v in want.items()}
        assert out["stats"]["images"] == 5
    jmasks = _files(os.path.join(cfg.SAVE_DIR, "gtMask"))
    assert _files(os.path.join(pcfg.SAVE_DIR, "gtMask")) == jmasks
    assert len(jmasks) == 5
    _same_indicators(os.path.join(cfg.SAVE_DIR, "gtIndicator"),
                     os.path.join(pcfg.SAVE_DIR, "gtIndicator"))


def test_sigterm_to_one_rank_stops_both(mini_root, tmp_path):
    """SIGTERM reaches rank 1 alone at step 3 of 12: both ranks stop at the
    poll of step 10, rank 0 writes the one ``preempt.ckpt``, and
    ``resume_full`` continues both to the end."""
    overrides = dict(OVERRIDES, **{"SOLVER.NUM_ITER": 24,
                                   "TPU.VAL_INTERVAL": 0})
    argv = _argv(os.path.join(CONFIGS, "gtav", "source_only.yaml"),
                 mini_root, tmp_path, "run", overrides, resume="")

    def send(procs, workdir):
        deadline = time.monotonic() + 150
        while not os.path.exists(os.path.join(workdir, "signal_me")):
            if (time.monotonic() > deadline
                    or any(p.poll() is not None for p in procs)):
                return
            time.sleep(0.05)
        os.kill(procs[1].pid, signal.SIGTERM)
        open(os.path.join(workdir, "signalled"), "w").close()

    outs = run_ranks("train", 2, tmp_path / "ranks", timeout=240,
                     args={"argv": argv, "no_dropout": True,
                           "signal_rank": 1, "signal_after": 3},
                     on_start=send)
    for out in outs:
        assert out["step"] == 10
        assert [r["step"] for r in out["history"]] == list(range(10))
    assert outs[0]["saved"] == ["preempt.ckpt", "last.ckpt"]
    assert outs[1]["saved"] == []
    path = str(tmp_path / "run" / "preempt.ckpt")
    outs = run_ranks("resume", 2, tmp_path / "resume", timeout=150,
                     args={"argv": argv, "path": path})
    for out in outs:
        assert out["start"] == 10 and out["step"] == 12
        assert [r["step"] for r in out["history"]] == [10, 11]
    assert outs[0]["history"] == outs[1]["history"]


def test_test_entry_two_ranks_matches_one_process(mini_root, tmp_path):
    """``test.main`` on 2 ranks (the plain eval: 3 val images in global
    batches of 2, the padded position ignored; the rich eval whole on
    each rank, artifacts from rank 0 alone) against one process."""
    torch.manual_seed(0)
    config = os.path.join(CONFIGS, "gtav", "test.yaml")
    overrides = {k: v for k, v in OVERRIDES.items()
                 if k.startswith(("MODEL.", "INPUT.", "TPU.L", "SEED"))}
    for rich in (False, True):
        extra = {"TEST.SAVE_EMBED": rich, "resume": ""}
        one = port_test.main(_argv(config, mini_root, tmp_path,
                                   f"one{rich}", overrides, **extra),
                             device="cpu")
        outs = run_ranks("test_entry", 2, tmp_path / f"ranks{rich}",
                         timeout=150, args={"argv": _argv(
                             config, mini_root, tmp_path, f"two{rich}",
                             overrides, **extra)})
        for out in outs:
            assert out["result"] == one
        assert len(outs[0]["saved"]) == (3 if rich else 0)
        assert outs[1]["saved"] == []
