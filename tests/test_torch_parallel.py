"""Port parity, data parallelism (``halo_tpu_torch/parallel``): the
``multihost`` helpers (the identity in one process, over 2 and 4 gloo
ranks), the synced BatchNorm, the global loss denominators and the int8
calibration against one process on the whole batch, the int8 sweep twin's
calibration on 2 ranks against the JAX twin's under ``TPU.DATA_PARALLEL
2``, the loader shards against the JAX loader's
``local_batch_indices``, ``spatial_region_score`` on 2 and 4 ranks against
the whole-map score of both packages, and the refusals of
``parallel.mesh`` and the learners.

Rank processes start through ``tests/torch_parallel_worker.py`` (fresh
interpreters, one torch thread, a ``file://`` rendezvous, each run joined
with a timeout). Tolerances: 1e-6 (float32; sums in another order)."""

import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from halo_tpu.active.scoring import \
    spatial_region_score as jax_spatial_region_score
from halo_tpu.data.loader import DataLoader as JaxLoader
from halo_tpu.engine import build_learner as jax_build_learner
from halo_tpu.models import layers as jax_layers
from halo_tpu.parallel import create_mesh
from halo_tpu_torch.active.scoring import floating_region_score
from halo_tpu_torch.config import get_default_cfg
from halo_tpu_torch.data.build import (EpochBatchSampler, ShardedBatches,
                                       SizeGroupedBatches,
                                       build_active_loader,
                                       build_test_loader, build_train_loader)
from halo_tpu_torch.losses import (cross_entropy_loss, local_consistent_loss,
                                   negative_learning_loss)
from halo_tpu_torch.models import variables_to_state_dict
from halo_tpu_torch.ops import quant
from halo_tpu_torch.parallel import mesh, multihost
from halo_tpu_torch.parallel.launch import TORCHRUN_VARS
from tests.conftest import add_mixed_size_images, build_mini_dataset
from tests.test_engine import tiny_cfg
from tests.torch_parallel_worker import run_ranks


@pytest.fixture()
def no_torchrun(monkeypatch):
    for name in TORCHRUN_VARS:
        monkeypatch.delenv(name, raising=False)


def test_helpers_are_the_identity_in_one_process(no_torchrun):
    assert mesh.init_from_env("cpu") == "cpu"
    assert mesh.init_from_env() is None and mesh.group() is None
    assert (multihost.process_index(), multihost.process_count()) == (0, 1)
    assert multihost.is_coordinator() and multihost.loader_shard() is None
    multihost.sync_hosts("nothing to wait for")
    assert multihost.any_host_flag(True) is True
    assert multihost.any_host_flag(False) is False
    stats = {"images": 3, "picked": 10, "labeled_px": 90}
    assert multihost.sum_over_hosts(stats) == stats
    assert multihost.broadcast_seed(1234) == 1234


@pytest.mark.parametrize("world", [2, 4])
def test_helpers_over_ranks(world, tmp_path):
    outs = run_ranks("multihost", world, tmp_path)
    for rank, out in enumerate(outs):
        assert (out["rank"], out["count"]) == (rank, world)
        assert out["coordinator"] == (rank == 0)
        assert out["shard"] == (rank, world)
        assert out["flag_last"] is True and out["flag_none"] is False
        assert out["seed"] == 1000  # rank 0's
        sums = out["sums"]
        assert sums["images"] == world * (world + 1) // 2
        assert type(sums["images"]) is int
        assert sums["big"] == world * 2 ** 60 + world * (world - 1) // 2
        # int on rank 0 only: summed as a float on every rank
        assert sums["mixed"] == 1 + sum(0.5 + r for r in range(1, world))
        assert type(sums["mixed"]) is float
        assert sums["loss"] == pytest.approx(0.25 * world * (world + 1) / 2)
    assert all(out["sums"] == outs[0]["sums"] for out in outs)


def test_sync_batchnorm_matches_one_process(tmp_path):
    """2 ranks, each half the batch, against ``nn.BatchNorm`` over the
    whole batch: outputs, running statistics after two updates, eval
    outputs, and the input and weight gradients."""
    rng = np.random.default_rng(0)
    c = 6
    blob = {"x1d": rng.normal(1.5, 2.0, (40, c)),
            "g1d": rng.normal(size=(40, c)),
            "x2d": rng.normal(-0.5, 1.5, (4, c, 7, 5)),
            "g2d": rng.normal(size=(4, c, 7, 5)),
            "w": rng.normal(1.0, 0.2, c), "b": rng.normal(0.0, 0.2, c)}
    blob = {k: torch.as_tensor(v, dtype=torch.float32)
            for k, v in blob.items()}
    torch.save(blob, tmp_path / "in.pt")
    outs = run_ranks("sync_bn", 2, tmp_path)
    for kind, cls in (("1d", torch.nn.BatchNorm1d),
                      ("2d", torch.nn.BatchNorm2d)):
        bn = cls(c, eps=1e-5, momentum=0.1)
        with torch.no_grad():
            bn.weight.copy_(blob["w"])
            bn.bias.copy_(blob["b"])
        x = blob[f"x{kind}"].clone().requires_grad_(True)
        for _ in range(2):
            y = bn(x)
            (y * blob[f"g{kind}"]).sum().backward()
        bn.eval()
        want = {"y": y.detach(), "dx": x.grad, "dw": bn.weight.grad,
                "db": bn.bias.grad, "mean": bn.running_mean,
                "var": bn.running_var, "eval": bn(x).detach()}
        got = {k: [out[kind][k] for out in outs] for k in want}
        for k in ("y", "dx", "eval"):
            np.testing.assert_allclose(torch.cat(got[k]).numpy(),
                                       want[k].numpy(), rtol=0, atol=1e-6,
                                       err_msg=f"{kind} {k}")
        for k in ("dw", "db", "mean", "var"):
            for g in got[k]:
                np.testing.assert_allclose(
                    g.numpy(), want[k].numpy(), rtol=1e-6, atol=1e-6,
                    err_msg=f"{kind} {k}")
        assert [out[kind]["tracked"] for out in outs] == [2, 2]


def test_global_denominators(tmp_path):
    """Unequal labelled pixels on the two ranks: the reduced gradient of
    CE + negative + LCR equals the one-process gradient of their global
    means; the mean of the ranks' own means is another loss."""
    rng = np.random.default_rng(1)
    n, h, w, f, k = 4, 6, 7, 5, 4
    labels = rng.integers(0, k, (n, h, w))
    labels[:2][rng.random((2, h, w)) < 0.8] = 255   # rank 0: few pixels
    labels[2:][rng.random((2, h, w)) < 0.1] = 255   # rank 1: many
    blob = {"x": torch.as_tensor(rng.normal(size=(n, h, w, f)),
                                 dtype=torch.float32),
            "w": torch.as_tensor(rng.normal(size=(f, k)),
                                 dtype=torch.float32),
            "labels": torch.as_tensor(labels)}
    torch.save(blob, tmp_path / "in.pt")
    outs = run_ranks("denominators", 2, tmp_path)
    assert outs[0]["valid"] != outs[1]["valid"]

    wt = blob["w"].clone().requires_grad_(True)
    logits = blob["x"] @ wt
    terms = (cross_entropy_loss(logits, blob["labels"], 255),
             negative_learning_loss(F.softmax(logits, -1), 0.05),
             local_consistent_loss(logits, blob["labels"],
                                   ignore_index=255))
    sum(terms).backward()
    for out in outs:
        np.testing.assert_allclose(out["grad"].numpy(), wt.grad.numpy(),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(out["global"],
                                   [float(t.detach()) for t in terms],
                                   rtol=1e-6)
    naive = np.mean([out["local"] for out in outs], axis=0)
    assert abs(naive[0] - float(terms[0])) > 1e-3
    assert abs(naive[2] - float(terms[2])) > 1e-3
    assert torch.equal(outs[0]["grad"], outs[1]["grad"])
    for out in outs:
        assert torch.equal(out["lone"], torch.full((8, 16, 1, 1), 1.5))


def test_all_ignored_batch_gives_zero_over_ranks(tmp_path):
    """The all-ignored CE is exactly 0 on every rank (global denominator
    clamped at 1)."""
    blob = {"x": torch.randn(2, 3, 4, 5), "w": torch.randn(5, 3),
            "labels": torch.full((2, 3, 4), 255)}
    torch.save(blob, tmp_path / "in.pt")
    outs = run_ranks("denominators", 2, tmp_path)
    for out in outs:
        assert out["global"][0] == 0.0 and out["global"][2] == 0.0
        assert out["valid"] == 0


def test_calibration_over_ranks_with_an_idle_rank(tmp_path):
    """``ops.quant.calibrate(group=)`` where rank 0 has two batches and
    rank 1 none (its slices all padding): both ranks end with the
    quantisation state and int8 output of one process calibrated on the
    two batches, bit for bit."""
    from tests.torch_parallel_worker import _calib_model
    torch.manual_seed(3)
    state = _calib_model().state_dict()
    gen = torch.Generator().manual_seed(3)
    batches = [torch.randn(2, 3, 8, 8, generator=gen) * s for s in (1, 3)]
    x = torch.randn(1, 3, 8, 8, generator=gen)
    torch.save({"state": state, "batches": [batches, []], "x": x},
               tmp_path / "in.pt")
    outs = run_ranks("calibrate", 2, tmp_path)
    model = _calib_model(state)
    quant.calibrate(model, batches)
    want = quant.quant_state(model)
    for out in outs:
        assert out["quant"].keys() == want.keys()
        for name, entry in want.items():
            for key, value in entry.items():
                assert torch.equal(out["quant"][name][key], value), (name,
                                                                     key)
        assert torch.equal(out["y"], model(x).detach())
    with pytest.raises(ValueError, match="at least one batch"):
        quant.calibrate(_calib_model(state), [])


def test_quant_sweep_calibration_two_ranks_matches_jax(tmp_path,
                                                      monkeypatch):
    """``TPU.QUANT_SWEEP`` on 2 ranks over the mixed-size target set at
    ``TPU.ACTIVE_BATCH`` 1: rank 1's slice of global batch 1 (the 32x64
    bucket's padded last one) is all padding and skipped, so its second
    batch is global batch 2, a 40x72 image. The twin calibrates on this
    rank's slices of the first ``TPU.QUANT_CALIB_BATCHES`` 2 global
    batches (images 0-2) alone, and its amax, int8 weights and scales are
    the JAX twin's under ``TPU.DATA_PARALLEL 2`` (amax within 4e-6
    relative, as ``tests/test_torch_protocols.py`` holds them). Image 4
    is a 0/255 checkerboard of 8-pixel squares, whose activations exceed
    the noise images', so a calibration that took it in would show."""
    from PIL import Image

    from halo_tpu_torch.models.convert import quant_tree_to_state
    root = build_mini_dataset(tmp_path / "datasets")
    names = add_mixed_size_images(root)
    board = ((np.indices((40, 72)) // 8).sum(0) % 2 * 255).astype(np.uint8)
    Image.fromarray(np.repeat(board[..., None], 3, -1)).save(
        root / "cityscapes" / "leftImg8bit" / "train" / names[1])
    cfg = tiny_cfg(root, tmp_path, "source_target", devices=2)
    cfg.TPU.QUANT_SWEEP = True
    cfg.TPU.ACTIVE_BATCH = 1
    cfg.TPU.QUANT_CALIB_BATCHES = 2
    for name in ("DENSE_CONV_MODE", "STENCIL_TRAIN", "CONV_WGRAD",
                 "QUANT_EVAL"):  # module globals the JAX learner sets
        monkeypatch.setattr(jax_layers, name, getattr(jax_layers, name))
    learner = jax_build_learner(cfg)
    assert learner.num_devices == 2
    want = quant_tree_to_state(jax.tree_util.tree_map(
        np.asarray, learner._sweep_model_state()[1].quant))
    init = str(tmp_path / "init.ckpt")
    torch.save({"state_dict": variables_to_state_dict(jax.tree_util.tree_map(
        np.asarray, learner.state.variables()))}, init)

    pcfg = get_default_cfg()
    pcfg.set_new_allowed(True)
    pcfg.merge_from_other_cfg(cfg)
    pcfg.SAVE_DIR = str(tmp_path / "port")
    pcfg.resume = init
    work = tmp_path / "ranks"
    work.mkdir()
    (work / "cfg.yaml").write_text(pcfg.dump())
    outs = run_ranks("quant_sweep", 2, work, timeout=150)
    assert outs[0]["numbers"] == [0, 1, 2]
    assert outs[1]["numbers"] == [0, 2]
    for out in outs:
        got = out["quant"]
        assert got.keys() == want.keys() and got
        for layer in got:
            assert torch.equal(got[layer]["w_int8"], want[layer]["w_int8"])
            assert torch.equal(got[layer]["w_scale"],
                               want[layer]["w_scale"])
            np.testing.assert_allclose(got[layer]["amax"],
                                       want[layer]["amax"], rtol=4e-6,
                                       err_msg=layer)


class _Indices:
    """A dataset of indices with two native sizes (for the sweep)."""

    def __init__(self, sizes):
        self.sizes = sizes

    def __len__(self):
        return len(self.sizes)

    def __getitem__(self, index):
        return {"i": index}

    def native_size(self, index):
        return self.sizes[index]


def _jax_batches(dataset, batch_size, shard, **kw):
    loader = JaxLoader(dataset, batch_size=batch_size, num_workers=1,
                       shard=shard, collate_fn=lambda s: {
                           "i": [x["i"] for x in s]}, **kw)
    return [(b["i"], list(b.get("is_pad", [False] * len(b["i"]))))
            for b in loader]


@pytest.mark.parametrize("world", [2, 4])
def test_loader_shards_match_jax(world):
    """Index for index and pad for pad against the JAX loader (which
    slices with ``local_batch_indices``): the shuffled train batches
    (last partial one dropped), the sweep over two native sizes (each
    size's last batch partial and padded) and the eval batches (the last
    padded)."""
    sizes = [(32, 64)] * 9 + [(40, 72)] * 5
    ds = _Indices(sizes)
    batch = 2 * world
    for rank in range(world):
        shard = (rank, world)
        # train: one epoch of EpochBatchSampler keys against the JAX
        # loader's epoch 3
        sampler = EpochBatchSampler(len(ds), batch, seed=7, shard=shard)
        sampler.set_epoch(3)
        jl = JaxLoader(ds, batch_size=batch, shuffle=True, num_workers=1,
                       seed=7, drop_last=True, shard=shard,
                       collate_fn=lambda s: {"i": [x["i"] for x in s]})
        jl.set_epoch(3)
        assert [[i for _, i in b] for b in sampler] == [b["i"] for b in jl]
        # sweep: non-pad indices and their positions in the sweep
        sweep = SizeGroupedBatches(ds, batch, shard)
        want, pos = [], []
        for n, (idx, pads) in enumerate(_jax_batches(
                ds, batch, shard, pad_final=True, group_by_size=True)):
            keep = [b for b, p in enumerate(pads) if not p]
            if keep:
                want.append([idx[b] for b in keep])
                pos.append([n * batch + rank * 2 + b for b in keep])
        assert sweep.batches == want and sweep.positions == pos
        # eval: indices and pads
        got = [([i for i, _ in b], [p for _, p in b])
               for b in ShardedBatches(len(ds), batch, shard)]
        assert got == _jax_batches(ds, batch, shard, pad_final=True)
    with pytest.raises(ValueError):
        EpochBatchSampler(10, 3, seed=0, shard=(0, 2))


def test_rank_slices_reassemble_the_global_batches(tmp_path):
    """The port's loaders on the mini dataset: the two ranks' slices,
    put side by side, are the one-process global batches byte for byte
    (train: GTAV images in global batches of 2; the sweep over two
    native sizes; eval with a padded last batch, whose padded position
    is flagged)."""
    root = build_mini_dataset(tmp_path / "datasets")
    add_mixed_size_images(root)
    cfg = get_default_cfg()
    cfg.set_new_allowed(True)
    cfg.merge_from_file(os.path.join(os.path.dirname(__file__), os.pardir,
                                     "configs", "gtav", "source_target.yaml"))
    cfg.TPU.DATASET_DIR = str(root)
    cfg.SAVE_DIR = str(tmp_path / "out")
    for key, size in (("SOURCE_INPUT_SIZE_TRAIN", (48, 24)),
                      ("TARGET_INPUT_SIZE_TRAIN", (48, 24)),
                      ("INPUT_SIZE_TEST", (48, 24))):
        setattr(cfg.INPUT, key, size)
    cfg.TPU.ACTIVE_BATCH = 1
    cfg.TEST.BATCH_SIZE = 1
    from halo_tpu_torch.data.catalog import DatasetCatalog
    DatasetCatalog.init_mask(cfg)

    def cat(batches, key):
        return [np.concatenate([np.asarray(b[key]) for b in group])
                for group in zip(*batches)]

    whole = build_train_loader(cfg, True, 2, seed=3, num_workers=0)
    parts = [build_train_loader(cfg, True, 2, seed=3, num_workers=0,
                                shard=(r, 2)) for r in range(2)]
    for loader in [whole] + parts:
        loader.batch_sampler.set_epoch(1)
    want = list(itertools.islice(whole, 3))
    parts = [list(itertools.islice(p, 3)) for p in parts]
    for key in ("img", "label"):
        got = cat(parts, key)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g.tobytes() == np.asarray(w[key]).tobytes()

    # the sweep: ACTIVE_BATCH 1 a rank, batches of 2 by native size
    whole = list(build_active_loader(cfg, 0, shard=None))
    cfg.TPU.ACTIVE_BATCH = 2
    glob = [b["img"] for b in build_active_loader(cfg, 0)]
    cfg.TPU.ACTIVE_BATCH = 1
    parts = [list(build_active_loader(cfg, 0, shard=(r, 2)))
             for r in range(2)]
    assert [len(p) for p in parts] == [3, 2]   # the padded one skipped
    order = [parts[0][0], parts[1][0], parts[0][1], parts[0][2], parts[1][1]]
    flat = np.concatenate([np.asarray(g) for g in glob])
    assert np.concatenate([np.asarray(b["img"]) for b in order]).tobytes() \
        == flat.tobytes()
    assert len(whole) == 5

    # eval: 3 val images, global batches of 2, the last padded
    whole = list(build_test_loader(cfg, 0))
    parts = [list(build_test_loader(cfg, 0, shard=(r, 2)))
             for r in range(2)]
    assert [b["is_pad"] for b in parts[1]] == [[False], [True]]
    real = [b for pair in zip(*parts) for b in pair
            if not b["is_pad"][0]]
    assert len(real) == len(whole) == 3
    for g, w in zip(real, whole):
        for key in ("img", "label"):
            assert np.asarray(g[key]).tobytes() == \
                np.asarray(w[key]).tobytes()


@pytest.mark.parametrize("world", [2, 4])
def test_spatial_region_score_matches_whole_map(world, tmp_path):
    """H = 64 rows in 2 or 4 contiguous shards: each rank's rows of
    (score, impurity, uncertainty) against the port's
    ``floating_region_score`` of the whole map and the JAX package's
    ``spatial_region_score`` (H over the mesh's model axis), for both
    purity pairs of ``tests/test_parallel.py``; an H of 30 in unequal
    shards raises on every rank."""
    pairs = [("radius", "entropy"), ("ripu", "pixel_entropy")]
    rng = np.random.default_rng(3)
    H, W, C, E = 64, 48, 19, 8
    logits = rng.normal(size=(H, W, C)).astype(np.float32)
    embed = (rng.normal(size=(H, W, E)) * 0.3).astype(np.float32)
    torch.save({"logits": torch.from_numpy(logits),
                "embed": torch.from_numpy(embed)}, tmp_path / "in.pt")
    outs = run_ranks("spatial", world, tmp_path,
                     args={"pairs": pairs})
    jmesh = create_mesh(data_parallel=1, spatial_parallel=world)
    for pur, unc in pairs:
        opts = dict(unc_type=unc, pur_type=pur, size=3, num_classes=C,
                    normalize=True)
        want = floating_region_score(torch.from_numpy(logits),
                                     torch.from_numpy(embed), **opts)
        jax_want = jax_spatial_region_score(
            jnp.asarray(logits), jnp.asarray(embed), mesh=jmesh, **opts)
        for i, name in enumerate(("score", "impurity", "uncertainty")):
            got = torch.cat([out[(pur, unc)][i] for out in outs]).numpy()
            np.testing.assert_allclose(got, want[i].numpy(), rtol=0,
                                       atol=1e-6, err_msg=f"{pur} {name}")
            np.testing.assert_allclose(got, np.asarray(jax_want[i]),
                                       rtol=0, atol=1e-6,
                                       err_msg=f"{pur} {name} vs JAX")
    for out in outs:
        assert "not divisible" in out["indivisible"]
    jax.clear_caches()


def test_refusals(tmp_path, mini_root, monkeypatch):
    """``init_from_env`` refuses NCCL on the CPU, a LOCAL_RANK with no CUDA
    device, a named device that does not exist and an unknown backend;
    two ranks on one CUDA device under NCCL raise on both ranks (the
    check, driven over gloo with a device index of the card); a learner
    refuses ``TPU.DATA_PARALLEL`` other than -1 or the world size, and
    ``TPU.SPATIAL_PARALLEL`` other than 1."""
    outs = run_ranks("refusals", 2, tmp_path)
    for out in outs:
        assert out["nccl_on_cpu"].startswith("ValueError")
        assert out["local_rank_device"].startswith("RuntimeError")
        assert "LOCAL_RANK" in out["local_rank_device"]
        assert out["no_device"].startswith("RuntimeError")
        assert out["backend"].startswith("ValueError")
        assert "share one CUDA device" in out["shared"]
        assert out["group_after"] is False

    from halo_tpu_torch.engine.learners import build_learner
    for name in TORCHRUN_VARS:
        monkeypatch.delenv(name, raising=False)
    cfg = get_default_cfg()
    cfg.MODEL.NAME = "deeplabv3plus_resnettiny"
    cfg.MODEL.WEIGHTS = ""
    cfg.PROTOCOL = "source"
    cfg.TPU.DATASET_DIR = str(mini_root)
    cfg.TPU.DATA_PARALLEL = 2
    with pytest.raises(ValueError, match="DATA_PARALLEL"):
        build_learner(cfg, device="cpu")
    cfg.TPU.DATA_PARALLEL = 1
    cfg.TPU.SPATIAL_PARALLEL = 2
    with pytest.raises(ValueError, match="SPATIAL_PARALLEL"):
        build_learner(cfg, device="cpu")
