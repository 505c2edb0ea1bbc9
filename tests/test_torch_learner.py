"""Port parity, the learner: ``halo_tpu_torch.train.main`` on the mini
dataset (resnettiny, kernel C's route, rounds at steps 0 and 2, 4 steps,
validation) against the JAX package's learner on the same config with
``TPU.DATA_PARALLEL 1``, from the same weights (the JAX init, handed to the
port through ``resume``) with dropout the identity in both.

Expected: the same metrics.jsonl schema, byte-identical round-1 masks and
per-step losses within 1e-4 relative (float32 compute and scoring; the
JAX model runs XLA's convs, the port kernel C's plain version, so sums
differ in order only).
"""

import io
import json
import os

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch
from PIL import Image

import halo_tpu.active.region_selection as jax_rs
from halo_tpu.config import get_default_cfg as jax_default_cfg
from halo_tpu.engine import build_learner as jax_build_learner
from halo_tpu.models import layers as jax_layers
from halo_tpu_torch import train
from halo_tpu_torch.data import mask_cache
from halo_tpu_torch.engine import learners as port_learners
from halo_tpu_torch.models import variables_to_state_dict

OVERRIDES = {
    "MODEL.NAME": "deeplabv3plus_resnettiny", "MODEL.REDUCED_CHANNELS": 16,
    "INPUT.SOURCE_INPUT_SIZE_TRAIN": (48, 24),
    "INPUT.TARGET_INPUT_SIZE_TRAIN": (48, 24),
    "INPUT.INPUT_SIZE_TEST": (48, 24),
    "SOLVER.NUM_ITER": 4, "SOLVER.WARMUP_ITERS": 2, "SOLVER.BASE_LR": 0.005,
    "ACTIVE.SELECT_ITER": [0, 2], "ACTIVE.MASK_RADIUS_K": 2,
    "TPU.COMPUTE_DTYPE": "float32", "TPU.SCORING_DTYPE": "float32",
    "TPU.VAL_INTERVAL": 4, "TPU.LOADER_WORKERS": 0, "SEED": 1,
}
CONFIG = os.path.join(os.path.dirname(__file__), os.pardir, "configs",
                      "gtav", "source_target.yaml")


def _mask_bytes(save_dir):
    root = os.path.join(save_dir, "gtMask")
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


def test_learner_matches_jax(mini_root, tmp_path, monkeypatch):
    for name in ("DENSE_CONV_MODE", "STENCIL_TRAIN", "CONV_WGRAD",
                 "QUANT_EVAL"):
        monkeypatch.setattr(jax_layers, name, getattr(jax_layers, name))
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, inputs, *a, **k: inputs)
    monkeypatch.setattr(torch.nn.Dropout2d, "forward", lambda self, x: x)
    rounds = {"jax": {}, "port": {}}

    def snapshot(side, fn):
        def wrapped(cfg, *args, **kwargs):
            stats = fn(cfg, *args, **kwargs)
            rounds[side][len(rounds[side]) + 1] = _mask_bytes(cfg.SAVE_DIR)
            return stats
        return wrapped

    monkeypatch.setattr(jax_rs, "region_selection",
                        snapshot("jax", jax_rs.region_selection))
    monkeypatch.setattr(port_learners, "region_selection",
                        snapshot("port", port_learners.region_selection))

    # The JAX learner.
    jcfg = jax_default_cfg()
    jcfg.set_new_allowed(True)
    jcfg.merge_from_file(CONFIG)
    for key, value in OVERRIDES.items():
        node, leaf = key.rsplit(".", 1) if "." in key else ("", key)
        setattr(jcfg.get(node) if node else jcfg, leaf, value)
    jcfg.MODEL.WEIGHTS = ""
    jcfg.resume = ""
    jcfg.TPU.DATA_PARALLEL = 1
    jcfg.TPU.DATASET_DIR = str(mini_root)
    jcfg.SAVE_DIR = str(tmp_path / "jax")
    learner = jax_build_learner(jcfg)
    init = os.path.join(tmp_path, "init.ckpt")
    torch.save({"state_dict": variables_to_state_dict(jax.tree_util.tree_map(
        np.asarray, learner.state.variables()))}, init)
    jhist = learner.fit(val_interval=4)

    # The port, through its entry point, resuming from the same weights.
    mask_cache.clear()
    argv = ["-cfg", CONFIG, "TPU.DENSE_CONV_MODE", "pallas",
            "MODEL.WEIGHTS", "", "resume", init,
            "TPU.DATASET_DIR", str(mini_root),
            "OUTPUT_DIR", str(tmp_path), "NAME", "port"]
    argv += [str(x) for k, v in OVERRIDES.items() for x in (k, v)]
    port = train.main(argv, device="cpu")
    save_dir = str(tmp_path / "port")
    assert port.cfg.SAVE_DIR == save_dir

    # metrics.jsonl: the JAX schema, one record a step, then the mIoU
    recs = _jsonl(save_dir)
    steps = [r for r in recs if "step" in r]
    assert [r["step"] for r in steps] == [0, 1, 2, 3]
    assert [r["active_round"] for r in steps] == [2, 2, 3, 3]
    jsteps = [r for r in _jsonl(jcfg.SAVE_DIR) if "step" in r]
    for got, want in zip(steps, jsteps):
        assert set(got) == set(want)
        for k in ("lr_fea", "lr_cls"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
    miou = [r["mIoU"] for r in recs if "mIoU" in r]
    assert len(miou) == 1 and np.isfinite(miou[0])

    # rounds at steps 0 and 2; round 1's masks byte-identical to JAX's
    assert sorted(rounds["port"]) == sorted(rounds["jax"]) == [1, 2]
    assert rounds["port"][1] == rounds["jax"][1]
    assert len(rounds["port"][1]) == 3
    labeled = [sum(int((np.asarray(Image.open(io.BytesIO(b))) != 255).sum())
                   for b in r.values())
               for r in (rounds["port"][1], rounds["port"][2])]
    assert 0 < labeled[0] < labeled[1]
    for name in ("last.ckpt", "model_before_round_1.ckpt",
                 "model_before_round_2.ckpt", "best_mIoU.ckpt"):
        assert os.path.exists(os.path.join(save_dir, name)), name

    # per-step losses within 1e-4
    assert len(jhist) == len(port.history) == 4
    for got, want in zip(port.history, jhist):
        for k in ("loss", "loss_sup", "loss_sup_tgt", "negative_loss"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       err_msg=f"step {got['step']} {k}")


def test_main_needs_cuda_or_explicit_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["-cfg", CONFIG, "MODEL.WEIGHTS", "", "resume", "",
                    "MODEL.NAME", "deeplabv3plus_resnettiny",
                    "OUTPUT_DIR", str(tmp_path)])
