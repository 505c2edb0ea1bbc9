"""Port parity, Cityscapes -> ACDC: ``ACDCDataSet`` and the catalog's
``acdc_*`` entries against the JAX package's on the synthetic ACDC tree
(``tests/conftest.py:add_acdc_dataset``: fog and night frames that share
basenames), and the ``configs/acdc/*.yaml`` pipeline on
``segformer_mittiny`` (hyperbolic, no HFR) through
``halo_tpu_torch.train.main`` and ``halo_tpu_torch.test.main`` against the
JAX learner and ``TestLearner``, float32 compute and scoring, dropout the
identity in both, ``TPU.REMAT`` on.

Expected: equal paths and byte-equal samples; round 1 (at step 1 of 3)
writes byte-identical mask PNGs and equal indicators under the nested
ACDC stems; per-step losses within 1e-4 relative; the test entries, both
resumed from the JAX run's msgpack ``last.ckpt``, give mIoU and per-class
IoU within 1e-3 percentage points.
"""

import json
import os
import pathlib
import tempfile

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from halo_tpu.config import get_default_cfg as jax_default_cfg
from halo_tpu.data.build import build_dataset as jax_build_dataset
from halo_tpu.data.catalog import DatasetCatalog as JaxCatalog
from halo_tpu.engine import build_learner as jax_build_learner
from halo_tpu.models import layers as jax_layers
from halo_tpu_torch import test as port_test
from halo_tpu_torch import train
from halo_tpu_torch.config import get_default_cfg
from halo_tpu_torch.data import mask_cache
from halo_tpu_torch.data.build import build_dataset
from halo_tpu_torch.data.catalog import DatasetCatalog
from halo_tpu_torch.data.masks import load_indicator
from halo_tpu_torch.models import variables_to_state_dict
from tests.conftest import add_acdc_dataset, make_mini_cfg
from tests.test_torch_eval import _jax_test, _same_result
from tests.test_torch_slice import _files

CONFIGS = os.path.join(os.path.dirname(__file__), os.pardir, "configs")


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


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data_cfgs(root, tmp_path):
    cfg = make_mini_cfg(root, tmp_path)
    cfg.DATASETS.SOURCE_TRAIN = "cityscapes_train"
    cfg.DATASETS.TARGET_TRAIN = "acdc_train"
    cfg.DATASETS.TEST = "acdc_val"
    pcfg = get_default_cfg()
    pcfg.set_new_allowed(True)
    pcfg.merge_from_other_cfg(cfg)
    return cfg, pcfg


@pytest.mark.parametrize("mode,is_source", [
    ("train", False), ("active", False), ("val", False), ("train", True)],
    ids=["target-train", "active", "val", "cityscapes-source"])
def test_acdc_dataset_matches_jax(tmp_path, mode, is_source):
    from tests.conftest import build_mini_dataset
    root = build_mini_dataset(tmp_path / "datasets")
    add_acdc_dataset(root)
    cfg, pcfg = _data_cfgs(root, tmp_path)
    JaxCatalog.init_mask(cfg)
    mask_cache.clear()
    want = jax_build_dataset(cfg, mode, is_source=is_source, epochwise=True)
    got = build_dataset(pcfg, mode, is_source=is_source, epochwise=True)
    assert type(got).__name__ == type(want).__name__
    assert len(got) == len(want) == (3 if is_source else 4)
    assert [e for e in got.data_list] == [e for e in want.data_list]
    if not is_source:
        stems = {e["label_mask"] for e in got.data_list}
        assert len(stems) == 4  # fog and night frames keep their own
    for i in range(len(got)):
        a, b = got[i], want[i]
        assert set(a) <= set(b)
        for k, v in a.items():
            if isinstance(v, str):
                assert v == b[k], k
            else:
                np.testing.assert_array_equal(np.asarray(v),
                                              np.asarray(b[k]), err_msg=k)


def test_init_mask_walks_acdc_stems(tmp_path):
    """Both packages' ``init_mask`` write the same mask and indicator
    files under the nested stems."""
    from tests.conftest import build_mini_dataset
    root = build_mini_dataset(tmp_path / "datasets")
    add_acdc_dataset(root)
    cfg, pcfg = _data_cfgs(root, tmp_path)
    pcfg.SAVE_DIR = str(tmp_path / "port")
    JaxCatalog.init_mask(cfg)
    DatasetCatalog.init_mask(pcfg)
    for kind in ("gtMask", "gtIndicator"):
        jfiles = _files(os.path.join(cfg.SAVE_DIR, kind))
        pfiles = _files(os.path.join(pcfg.SAVE_DIR, kind))
        assert jfiles.keys() == pfiles.keys() and len(jfiles) == 4
    assert "train/fog/GOPR0000/GOPR0000_frame_000000_gt_labelIds.png" in \
        _files(os.path.join(pcfg.SAVE_DIR, "gtMask"))


OVERRIDES = {
    "MODEL.NAME": "segformer_mittiny", "MODEL.REDUCED_CHANNELS": 16,
    "INPUT.SOURCE_INPUT_SIZE_TRAIN": (64, 32),
    "INPUT.TARGET_INPUT_SIZE_TRAIN": (64, 32),
    "INPUT.INPUT_SIZE_TEST": (64, 32),
    "SOLVER.NUM_ITER": 3, "SOLVER.WARMUP_ITERS": 0,
    "ACTIVE.SELECT_ITER": [1], "ACTIVE.MASK_RADIUS_K": 2,
    "TPU.COMPUTE_DTYPE": "float32", "TPU.SCORING_DTYPE": "float32",
    "TPU.REMAT": True, "TPU.VAL_INTERVAL": 0, "TPU.LOADER_WORKERS": 0,
    "MODEL.WEIGHTS": "", "SEED": 1,
}


def _argv(recipe, root, out, name, **extra):
    items = dict(OVERRIDES, **extra)
    return (["-cfg", os.path.join(CONFIGS, "acdc", recipe),
             "TPU.DATASET_DIR", str(root), "OUTPUT_DIR", str(out),
             "NAME", name] + [str(x) for k, v in items.items()
                              for x in (k, v)])


def test_acdc_pipeline_matches_jax(tmp_path, monkeypatch):
    from tests.conftest import build_mini_dataset
    root = build_mini_dataset(tmp_path / "datasets")
    add_acdc_dataset(root)
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, inputs, *a, **k: inputs)
    monkeypatch.setattr(torch.nn.Dropout, "forward", lambda self, x: x)

    # The JAX learner on the port's parsed config.
    from halo_tpu_torch.utils.misc import parse_args
    _, pcfg = parse_args(_argv("source_target.yaml", root, tmp_path, "jax",
                               resume=""))
    jcfg = jax_default_cfg()
    jcfg.set_new_allowed(True)
    jcfg.merge_from_other_cfg(pcfg)
    jcfg.TPU.DATA_PARALLEL = 1
    learner = jax_build_learner(jcfg)
    init = str(tmp_path / "init.ckpt")
    torch.save({"state_dict": variables_to_state_dict(jax.tree_util.tree_map(
        np.asarray, learner.state.variables()))}, init)
    jhist = learner.fit(val_interval=0)

    # The port through its entry point, from the same weights.
    mask_cache.clear()
    port = train.main(_argv("source_target.yaml", root, tmp_path, "port",
                            resume=init), device="cpu")
    assert port.cfg.MODEL.NAME == "segformer_mittiny"
    assert port.cfg.DATASETS.TARGET_TRAIN == "acdc_train"
    assert port.active_round == learner.active_round == 2
    for kind in ("gtMask", "gtIndicator"):
        jfiles = _files(os.path.join(jcfg.SAVE_DIR, kind))
        pfiles = _files(os.path.join(port.cfg.SAVE_DIR, kind))
        assert jfiles.keys() == pfiles.keys() and len(jfiles) == 4
        for rel in jfiles:
            if kind == "gtMask":
                with open(jfiles[rel], "rb") as a, open(pfiles[rel],
                                                        "rb") as b:
                    assert a.read() == b.read(), rel
            else:
                a, b = load_indicator(jfiles[rel]), load_indicator(
                    pfiles[rel])
                assert a.keys() == b.keys()
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k])
                assert a["selected"].shape == (32, 64)
                assert 0 < a["selected"].sum()
    assert "train/night/GOPR0001/GOPR0001_frame_000001_gt_labelIds.png" in \
        _files(os.path.join(port.cfg.SAVE_DIR, "gtMask"))
    assert len(jhist) == len(port.history) == 3
    for got, want in zip(port.history, jhist):
        for k in ("loss", "loss_sup", "loss_sup_tgt", "negative_loss"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       err_msg=f"step {got['step']} {k}")
    with open(os.path.join(port.cfg.SAVE_DIR, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["active_round"] for r in recs] == [1, 2, 2]

    # The test entries on acdc_val, both from the JAX run's last.ckpt.
    ckpt = os.path.join(jcfg.SAVE_DIR, "last.ckpt")
    argv = _argv("test.yaml", root, tmp_path, "test", resume=ckpt,
                 **{"TEST.SAVE_EMBED": True})
    jtest_cfg, want = _jax_test(argv)
    got = port_test.main(argv, device="cpu")
    _same_result(got, want, 19)
    names = sorted(os.listdir(os.path.join(jtest_cfg.SAVE_DIR, "embed")))
    assert names == sorted(os.listdir(os.path.join(str(tmp_path), "test",
                                                   "embed")))
    blob = torch.load(os.path.join(str(tmp_path), "test", "embed",
                                   names[0]))
    assert tuple(blob["embed"].shape) == (1, 8, 16, 16)
