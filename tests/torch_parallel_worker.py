"""Rank processes of the port's data-parallel tests (gloo on the CPU).

``run_ranks(case, world, workdir, ...)`` starts ``world`` fresh Python
processes of this file, each with the torchrun variables (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``) set and one torch thread, that rendezvous
through a ``file://`` store in ``workdir`` (no TCP port). Each runs
``case_<case>`` and writes its result to ``workdir/out_<rank>.pt``. Every
process is joined with a timeout and killed when it runs out
(``halo_tpu_torch.parallel.launch``), and the test then fails with the
processes' logs: a hung collective never holds the suite. The rank
processes import torch and ``halo_tpu_torch`` only.
"""

from __future__ import annotations

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_ranks(case, world, workdir, args=None, timeout=120.0,
              on_start=None):
    """Run ``case`` on ``world`` ranks; returns their results by rank.
    ``on_start(procs, workdir)`` runs in the parent once all are started
    (before any is joined)."""
    import torch

    from halo_tpu_torch.parallel.launch import run_processes

    workdir = str(workdir)
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "args.json"), "w") as f:
        json.dump(args or {}, f)
    store = os.path.join(workdir, f"rendezvous_{case}_{time.time_ns()}")
    envs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), OMP_NUM_THREADS="1",
                   MKL_NUM_THREADS="1", HALO_TEST_STORE=f"file://{store}")
        env.pop("PYTHONPATH", None)
        envs.append(env)
    try:
        run_processes(
            [[sys.executable, os.path.abspath(__file__), case, workdir]]
            * world, envs,
            [os.path.join(workdir, f"log_{case}_{r}.txt")
             for r in range(world)], timeout, cwd=REPO,
            on_start=(None if on_start is None
                      else lambda procs: on_start(procs, workdir)))
    except RuntimeError as e:
        raise AssertionError(f"{case}: {e}") from None
    return [torch.load(os.path.join(workdir, f"out_{r}.pt"),
                       weights_only=False) for r in range(world)]


# ---------------------------------------------------------------------------
# The cases (run in the rank processes)
# ---------------------------------------------------------------------------

def _init_group():
    from halo_tpu_torch.parallel import mesh
    return mesh.init_from_env("cpu", init_method=os.environ[
        "HALO_TEST_STORE"])


def case_multihost(args, rank, world, workdir):
    import torch.distributed as dist

    from halo_tpu_torch.parallel import mesh, multihost
    _init_group()
    assert mesh.group() is dist.group.WORLD
    out = {"rank": multihost.process_index(),
           "count": multihost.process_count(),
           "coordinator": multihost.is_coordinator(),
           "shard": multihost.loader_shard(),
           "flag_last": multihost.any_host_flag(rank == world - 1),
           "flag_none": multihost.any_host_flag(False),
           "seed": multihost.broadcast_seed(1000 + 7 * rank),
           # int on rank 0, float elsewhere; an int64 beyond 2^53
           "sums": multihost.sum_over_hosts({
               "images": rank + 1, "big": 2 ** 60 + rank,
               "mixed": 1 if rank == 0 else 0.5 + rank,
               "loss": 0.25 * (rank + 1)})}
    multihost.sync_hosts("end")
    mesh.destroy()
    return out


def case_sync_bn(args, rank, world, workdir):
    import torch
    import torch.distributed as dist

    from halo_tpu_torch.parallel import collectives, mesh
    _init_group()
    blob = torch.load(os.path.join(workdir, "in.pt"))
    out = {}
    for kind in ("1d", "2d"):
        x, g = blob[f"x{kind}"], blob[f"g{kind}"]
        per = x.shape[0] // world
        x = x[rank * per:(rank + 1) * per].clone().requires_grad_(True)
        g = g[rank * per:(rank + 1) * per]
        bn = (torch.nn.BatchNorm1d if kind == "1d" else torch.nn.BatchNorm2d)(
            x.shape[1], eps=1e-5, momentum=0.1)
        with torch.no_grad():
            bn.weight.copy_(blob["w"])
            bn.bias.copy_(blob["b"])
        names = [n for n, _ in bn.named_parameters()] + [
            n for n, _ in bn.named_buffers()]
        assert collectives.convert_sync_batchnorm(bn, dist.group.WORLD) == 1
        assert names == [n for n, _ in bn.named_parameters()] + [
            n for n, _ in bn.named_buffers()]
        ys = []
        for _ in range(2):  # two updates of the running statistics
            y = bn(x)
            (y * g).sum().backward()
            ys.append(y.detach())
        grads = [bn.weight.grad, bn.bias.grad]
        for t in grads:  # the parameters' gradient over the whole batch
            dist.all_reduce(t)
        bn.eval()
        out[kind] = {"y": ys[-1], "dx": x.grad, "dw": grads[0],
                     "db": grads[1], "mean": bn.running_mean.clone(),
                     "var": bn.running_var.clone(),
                     "tracked": int(bn.num_batches_tracked),
                     "eval": bn(x).detach()}
    mesh.destroy()
    return out


def case_denominators(args, rank, world, workdir):
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from halo_tpu_torch.losses import (cross_entropy_loss,
                                       local_consistent_loss,
                                       negative_learning_loss)
    from halo_tpu_torch.parallel import collectives, mesh
    _init_group()
    blob = torch.load(os.path.join(workdir, "in.pt"))
    per = blob["x"].shape[0] // world
    x = blob["x"][rank * per:(rank + 1) * per]
    labels = blob["labels"][rank * per:(rank + 1) * per]
    w = blob["w"].clone().requires_grad_(True)
    group = dist.group.WORLD

    def losses(grp):
        logits = x @ w
        return (cross_entropy_loss(logits, labels, 255, group=grp),
                negative_learning_loss(F.softmax(logits, -1), 0.05,
                                       group=grp),
                local_consistent_loss(logits, labels, ignore_index=255,
                                      group=grp))

    local = [float(v) for v in losses(None)]
    terms = losses(group)
    sum(terms).backward()
    collectives.all_reduce_gradients([w], group)
    # a bucket of one tensor whose flattening is a view of it (a 1x1
    # conv's channels-last gradient)
    v = torch.nn.Parameter(torch.zeros(8, 16, 1, 1).to(
        memory_format=torch.channels_last))
    v.grad = torch.full_like(v, float(rank + 1))
    collectives.all_reduce_gradients([v], group)
    out = {"grad": w.grad.clone(), "local": local, "lone": v.grad.clone(),
           "global": [float(v) for v in collectives.all_reduce_mean(
               list(terms), group)],
           "valid": int((labels != 255).sum())}
    mesh.destroy()
    return out


def case_calibrate(args, rank, world, workdir):
    """``ops.quant.calibrate`` over the group, each rank on its batches of
    ``in.pt`` (rank 1 on none): the quantisation state and the int8
    output."""
    import torch
    import torch.distributed as dist

    from halo_tpu_torch.ops import quant
    from halo_tpu_torch.parallel import mesh
    _init_group()
    blob = torch.load(os.path.join(workdir, "in.pt"))
    model = _calib_model(blob["state"])
    quant.calibrate(model, blob["batches"][rank], group=dist.group.WORLD)
    quant.assert_calibrated(model)
    out = {"quant": quant.quant_state(model),
           "y": model(blob["x"]).detach()}
    mesh.destroy()
    return out


def _calib_model(state=None):
    """Two quantised convs in eval mode, holding ``state`` if given."""
    import torch.nn as nn

    from halo_tpu_torch.models import layers
    model = nn.Sequential(layers.QuantConv(3, 8, 3, padding=1), nn.ReLU(),
                          layers.QuantConv(8, 4, 1))
    if state is not None:
        model.load_state_dict(state)
    return model.eval()


def case_spatial(args, rank, world, workdir):
    import torch
    import torch.distributed as dist

    from halo_tpu_torch.active.scoring import spatial_region_score
    from halo_tpu_torch.parallel import mesh
    _init_group()
    blob = torch.load(os.path.join(workdir, "in.pt"))
    per = blob["logits"].shape[0] // world
    rows = slice(rank * per, (rank + 1) * per)
    out = {}
    for pur, unc in args["pairs"]:
        out[(pur, unc)] = spatial_region_score(
            blob["logits"][rows], blob["embed"][rows],
            group=dist.group.WORLD, unc_type=unc, pur_type=pur, size=3,
            num_classes=blob["logits"].shape[-1], normalize=True)
    # an H of 30 rows cut into shards of unequal heights
    h = [8, 8, 7, 7][rank] if world == 4 else [16, 14][rank]
    try:
        spatial_region_score(torch.zeros(h, 16, 19), torch.zeros(h, 16, 8),
                             group=dist.group.WORLD)
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    mesh.destroy()
    return out


def case_refusals(args, rank, world, workdir):
    import torch

    from halo_tpu_torch.parallel import mesh
    out = {}
    for name, kwargs in (("nccl_on_cpu", {"device": "cpu",
                                          "backend": "nccl"}),
                         ("local_rank_device", {}),
                         ("no_device", {"device": "cuda:7"}),
                         ("backend", {"device": "cpu", "backend": "mpi"})):
        try:
            mesh.init_from_env(init_method=os.environ["HALO_TEST_STORE"],
                               **kwargs)
            out[name] = None
        except (ValueError, RuntimeError) as e:
            out[name] = f"{type(e).__name__}: {e}"
    _init_group()
    try:  # two ranks on cuda:0 under NCCL
        mesh._refuse_shared_devices(torch.device("cuda", 0), rank, world)
        out["shared"] = None
    except ValueError as e:
        out["shared"] = str(e)
    out["group_after"] = mesh.group() is not None
    mesh.destroy()
    return out


def _no_dropout():
    import torch
    torch.nn.Dropout.forward = lambda self, x: x
    torch.nn.Dropout2d.forward = lambda self, x: x


def _mask_bytes(save_dir):
    out = {}
    for kind in ("gtMask", "gtIndicator"):
        root = os.path.join(save_dir, kind)
        for dirpath, _dirs, names in os.walk(root):
            for name in names:
                path = os.path.join(dirpath, name)
                with open(path, "rb") as f:
                    out[os.path.join(kind, os.path.relpath(path, root))] = \
                        f.read()
    return out


def case_train(args, rank, world, workdir):
    """``train.main`` on the ranks; rank 0 snapshots each round's masks;
    every rank records the checkpoints it wrote and hashes its
    parameters."""
    import hashlib

    from halo_tpu_torch import train
    from halo_tpu_torch.engine import learners

    if args.get("no_dropout"):
        _no_dropout()
    saved, rounds = [], []
    save = learners.save_checkpoint
    learners.save_checkpoint = lambda model, path, **kw: (
        saved.append(os.path.basename(path)), save(model, path, **kw))[1]
    run_round = learners.region_selection

    def snapshot(cfg, *a, **kw):
        stats = run_round(cfg, *a, **kw)
        rounds.append((stats, _mask_bytes(cfg.SAVE_DIR) if rank == 0
                       else None))
        return stats

    learners.region_selection = snapshot
    sizes = []
    to_device = learners.Learner._to_device
    learners.Learner._to_device = lambda self, batch: (
        sizes.append(len(batch["img"])), to_device(self, batch))[1]
    if args.get("signal_rank") == rank:
        # the parent sends SIGTERM once this file exists
        def started(step):
            if step == args["signal_after"]:
                open(os.path.join(workdir, "signal_me"), "w").close()
                while not os.path.exists(os.path.join(workdir, "signalled")):
                    time.sleep(0.05)
            return False

        learners.Learner.on_batch_start = lambda self, step: started(step)
    learner = train.main(args["argv"], device="cpu",
                         init_method=os.environ["HALO_TEST_STORE"])
    digest = hashlib.sha256()
    for p in learner.model.parameters():
        digest.update(p.detach().numpy().tobytes())
    return {"history": learner.history, "saved": saved, "rounds": rounds,
            "params": digest.hexdigest(), "best_miou": learner.best_miou,
            "step": learner.step, "num_devices": learner.num_devices,
            "batch_sizes": sizes}


def case_test_entry(args, rank, world, workdir):
    """``test.main`` on the ranks; each records the artifacts it saved."""
    from halo_tpu_torch import test
    from halo_tpu_torch.engine import learners

    saved = []
    save = learners.TestLearner._save_artifacts
    learners.TestLearner._save_artifacts = lambda self, r, label, name: (
        saved.append(name), save(self, r, label, name))[1]
    result = test.main(args["argv"], device="cpu",
                       init_method=os.environ["HALO_TEST_STORE"])
    return {"result": result, "saved": saved}


def case_resume(args, rank, world, workdir):
    """A learner resumed from ``preempt.ckpt`` by ``resume_full`` runs to
    the end."""
    from halo_tpu_torch.config import get_default_cfg
    from halo_tpu_torch.engine.learners import build_learner
    from halo_tpu_torch.parallel import mesh
    from halo_tpu_torch.utils.misc import parse_args

    _no_dropout()
    _init_group()
    _, cfg = parse_args(args["argv"], cfg=get_default_cfg())
    learner = build_learner(cfg, device="cpu")
    start = learner.resume_full(args["path"])
    learner.fit(val_interval=0)
    mesh.destroy()
    return {"start": start, "step": learner.step,
            "history": learner.history}


def _workdir_cfg(workdir):
    """The port's config merged from ``workdir/cfg.yaml``."""
    from halo_tpu_torch.config import get_default_cfg
    cfg = get_default_cfg()
    cfg.set_new_allowed(True)
    cfg.merge_from_file(os.path.join(workdir, "cfg.yaml"))
    return cfg


def case_random_round(args, rank, world, workdir):
    """The ``random`` arm's round with no model on the ranks' slices."""
    from halo_tpu_torch.active.region_selection import region_selection
    from halo_tpu_torch.data.build import build_active_loader
    from halo_tpu_torch.engine.learners import _init_mask
    from halo_tpu_torch.parallel import mesh, multihost

    _init_group()
    cfg = _workdir_cfg(workdir)
    _init_mask(cfg)
    loader = build_active_loader(cfg, 0, shard=multihost.loader_shard())
    stats = region_selection(cfg, None, loader, args["round"],
                             progress=False, device="cpu")
    out = {"stats": stats, "positions": loader.batch_sampler.positions}
    mesh.destroy()
    return out


def case_quant_sweep(args, rank, world, workdir):
    """A learner's ``TPU.QUANT_SWEEP`` twin, calibrated for a round on the
    ranks' slices: its quantisation state."""
    from halo_tpu_torch.engine.learners import build_learner
    from halo_tpu_torch.ops import quant
    from halo_tpu_torch.parallel import mesh

    _init_group()
    learner = build_learner(_workdir_cfg(workdir), device="cpu")
    out = {"quant": quant.quant_state(learner._sweep_model()),
           "numbers": learner.active_loader.batch_sampler.numbers}
    mesh.destroy()
    return out


def main():
    case, workdir = sys.argv[1], sys.argv[2]
    sys.path.insert(0, REPO)
    import torch
    torch.set_num_threads(1)
    with open(os.path.join(workdir, "args.json")) as f:
        args = json.load(f)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    out = globals()[f"case_{case}"](args, rank, world, workdir)
    torch.save(out, os.path.join(workdir, f"out_{rank}.pt"))


if __name__ == "__main__":
    main()
