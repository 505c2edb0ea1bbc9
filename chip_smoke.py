#!/usr/bin/env python3
"""Smoke test of the PyTorch port (halo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--images N] [--profile TRACE.json]

Phases, each of which fails the run (non-zero exit) on any error:

  1. build   compile halo_tpu_torch/csrc/*.cu for sm_90a (one nvcc per
             source, in parallel) into build/cuda/.
  2. radius  kernel B against its plain version (dist0 in float32) on a
             (128, 2048, 64) bf16 block and a full 1024x2048x64 map,
             within 1e-6 relative; times kernel, plain version and
             torch.linalg.vector_norm.
  3. select  kernel A against its plain version (the column-cache loop),
             bit-exact, on a 1024x2048 map with 2331 picks, m = 5, a
             pre-active block and a tie plateau, plus an early-stop case;
             times both.
  4. slice   the acquisition round of configs/gtav/source_target.yaml
             (DeepLab-v3+ R101, hyperbolic head with HFR, 640x1280 input,
             entropy x radius, 1% a round) from a seeded random init over a
             synthetic 1024x2048 Cityscapes tree: 2331 picks an image,
             every mask PNG and indicator written, both kernels launched
             on the path (launch counters), ms/img by stage; then kernel A
             held bit-exact and kernel B within 1e-6 against their plain
             versions on the first image's real score map and embedding.

Prints the kernels JSON line, the card's name and power limit
(nvidia-smi), and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Needs a CUDA device and the repository around it; exits non-zero without.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
DEVICE = "cuda"
CONFIG = REPO / "configs" / "gtav" / "source_target.yaml"

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate and the float32
# rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def bound_ms(nbytes: float, flops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean ms of fn(i) over ``iters`` launches, by CUDA events."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_rel(torch, got, want) -> float:
    """Largest |got - want| / |want|; an exact zero must match exactly."""
    diff = (got - want).abs()
    zero = want == 0
    if bool((diff[zero] != 0).any()):
        return math.inf
    return float((diff[~zero] / want[~zero].abs()).max())


def ball_points(torch, shape, gen):
    """bf16 points of the Poincare ball: random directions, radii uniform
    in [0, 0.95)."""
    x = torch.randn(shape, generator=gen, device=DEVICE)
    r = torch.rand(shape[:-1] + (1,), generator=gen, device=DEVICE) * 0.95
    return (x / x.norm(dim=-1, keepdim=True) * r).to(torch.bfloat16)


def phase_radius(torch, gen, report):
    from halo_tpu_torch.active import cuda_radius
    full = ball_points(torch, (1024, 2048, 64), gen)
    worst, worst_abs = 0.0, 0.0
    for name, x in (("block", full[:128]), ("full", full)):
        got = cuda_radius.radius_map(x)
        want = cuda_radius.radius_map_reference(x)
        torch.cuda.synchronize()
        rel = max_rel(torch, got, want)
        worst = max(worst, rel)
        worst_abs = max(worst_abs, float((got - want).abs().max()))
        print(f"radius {name} {tuple(x.shape)}: max rel diff {rel:.3e}",
              flush=True)
    if worst > 1e-6:
        raise AssertionError(f"kernel B off its plain version: {worst}")
    # main-path shape: one 128-row block; rotate over the 8 blocks of the
    # full map (268 MB > L2) so each launch reads from device memory
    blocks = [full[i * 128:(i + 1) * 128] for i in range(8)]
    ms = cuda_ms(torch, lambda i: cuda_radius.radius_map(blocks[i % 8]), 64)
    plain = cuda_ms(torch, lambda i: cuda_radius.radius_map_reference(
        blocks[i % 8]), 16)
    lib = cuda_ms(torch, lambda i: torch.linalg.vector_norm(
        blocks[i % 8], dim=-1, dtype=torch.float32), 64)
    ms_full = cuda_ms(torch, lambda i: cuda_radius.radius_map(full), 16)
    n = 128 * 2048
    b_ms, b_by = bound_ms(n * 64 * 2 + n * 4, n * 64 * 2)
    b_full, _ = bound_ms(8 * (n * 64 * 2 + n * 4), 8 * n * 64 * 2)
    print(f"radius 128x2048x64 bf16: kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms, vector_norm {lib:.4f} ms, bound {b_ms:.4f} ms; "
          f"full 1024x2048x64: kernel {ms_full:.4f} ms, bound "
          f"{b_full:.4f} ms", flush=True)
    report["radius_map"] = {
        "name": "radius_map", "route": "cuda",
        "source": "halo_tpu_torch/csrc/radius.cu",
        "replaces": "halo_tpu/active/pallas_radius.py:100",
        "launches": 0, "max_abs_err": worst_abs, "ms": ms, "plain_ms": plain,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}


def plateau_map(torch, gen, h, w):
    """Random scores with a pre-active block (-inf) and a tie plateau."""
    score = torch.randn((h, w), generator=gen, device=DEVICE)
    score[100:300, 500:900] = float("-inf")
    score[600:640, 1200:1260] = 10.0   # many exact ties at the top
    return score


def phase_select(torch, gen, report, num_picks=2331, m=5):
    from halo_tpu_torch.active import cuda_select
    score = plateau_map(torch, gen, 1024, 2048)
    got = cuda_select.greedy_picks(score, num_picks=num_picks, mask_radius=m)
    want = cuda_select.greedy_picks_reference(score, num_picks=num_picks,
                                              mask_radius=m)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        bad = int((got[0] != want[0]).any(dim=1).nonzero()[0])
        raise AssertionError(
            f"kernel A differs from its plain version at pick {bad}: "
            f"{got[0][bad].tolist()} vs {want[0][bad].tolist()}")
    n = int(got[1])
    print(f"select 1024x2048 N={num_picks} m={m}: bit-exact, {n} picks",
          flush=True)
    tiny = torch.full((16, 16), float("-inf"), device=DEVICE)
    tiny[4, 7], tiny[12, 2] = 2.0, 1.0
    got = cuda_select.greedy_picks(tiny, num_picks=6, mask_radius=2)
    want = cuda_select.greedy_picks_reference(tiny, num_picks=6,
                                              mask_radius=2)
    if not (torch.equal(got[0], want[0]) and int(got[1]) == 2
            and int(want[1]) == 2):
        raise AssertionError(f"early stop: {got} vs {want}")
    print("select early stop: bit-exact, 2 picks", flush=True)
    ms = cuda_ms(torch, lambda i: cuda_select.greedy_picks(
        score, num_picks=num_picks, mask_radius=m), 5, warmup=1)
    t0 = time.perf_counter()
    cuda_select.greedy_picks_reference(score, num_picks=num_picks,
                                       mask_radius=m)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    b_ms, b_by = bound_ms(1024 * 2048 * 4 + num_picks * 2 * 4 + 4,
                          1024 * 2048 + n * (2 * m + 1) * 1024)
    print(f"select 1024x2048 N={num_picks}: kernel {ms:.3f} ms "
          f"({ms / num_picks * 1e3:.2f} us/pick), plain {plain:.1f} ms, "
          f"bound {b_ms:.4f} ms", flush=True)
    report["greedy_picks"] = {
        "name": "greedy_picks", "route": "cuda",
        "source": "halo_tpu_torch/csrc/select.cu",
        "replaces": "halo_tpu/active/pallas_select.py:119",
        "launches": 0, "max_abs_err": 0.0, "ms": ms, "plain_ms": plain,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def write_cityscapes(root: Path, n_images: int, seed: int):
    """A synthetic Cityscapes tree of 1024x2048 images: blocky random
    colours and label ids (16x16 blocks), from ``seed``."""
    import numpy as np
    from PIL import Image
    from halo_tpu_torch.data.datasets import ID_TO_TRAINID_19

    rng = np.random.default_rng(seed)
    ids = np.array(list(ID_TO_TRAINID_19) + [0], np.uint8)
    names = []
    for i in range(n_images):
        name = f"city{i}/city{i}_{i:06d}_000019_leftImg8bit.png"
        stem = name.split("_leftImg8bit")[0]
        img_p = root / "cityscapes" / "leftImg8bit" / "train" / name
        lab_p = (root / "cityscapes" / "gtFine" / "train"
                 / f"{stem}_gtFine_labelIds.png")
        img_p.parent.mkdir(parents=True, exist_ok=True)
        lab_p.parent.mkdir(parents=True, exist_ok=True)
        img = rng.integers(0, 256, (64, 128, 3), np.uint8)
        lab = rng.choice(ids, (64, 128))
        Image.fromarray(img.repeat(16, 0).repeat(16, 1)).save(img_p)
        Image.fromarray(lab.repeat(16, 0).repeat(16, 1)).save(lab_p)
        names.append(name)
    (root / "cityscapes_train_list.txt").write_text("\n".join(names) + "\n")


def summarize_profile(prof, wall_s: float, path: str):
    """Device busy time against the round's wall clock, and the kernels
    that take it, from a torch.profiler run; the trace goes to ``path``."""
    from torch.autograd import DeviceType
    prof.export_chrome_trace(path)
    # device-side events only: kernels and copies (the CPU ops that launch
    # them carry the same time again)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"profile: device busy {busy_ms:.1f} ms of {wall_s * 1e3:.1f} ms "
          f"wall (idle share {1 - busy_ms / (wall_s * 1e3):.3f}); trace "
          f"{path}", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x "
              f"{e.key[:90]}", flush=True)


def phase_slice(torch, args, report):
    from halo_tpu_torch.active import cuda_radius, cuda_select
    from halo_tpu_torch.active.region_selection import region_selection
    from halo_tpu_torch.active.scoring import fused_upsample_region_score
    from halo_tpu_torch.config import get_default_cfg
    from halo_tpu_torch.data.build import build_active_loader
    from halo_tpu_torch.data.catalog import DatasetCatalog
    from halo_tpu_torch.data.masks import load_indicator, load_mask_png
    from halo_tpu_torch.engine import make_forward
    from halo_tpu_torch.models import build_segmentor
    from halo_tpu_torch.ops.resize import resize_bilinear

    cfg = get_default_cfg()
    cfg.set_new_allowed(True)
    cfg.merge_from_file(str(CONFIG))
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        write_cityscapes(root / "datasets", args.images, args.seed)
        cfg.TPU.DATASET_DIR = str(root / "datasets")
        cfg.SAVE_DIR = str(root / "out")
        cfg.TPU.ACTIVE_BATCH = 4
        cfg.SEED = args.seed
        model = build_segmentor(
            cfg, device=DEVICE,
            generator=torch.Generator().manual_seed(args.seed))
        DatasetCatalog.init_mask(cfg)
        print(f"slice setup (data, model, masks): "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        dataset = build_active_loader(cfg, num_workers=0).dataset
        t0 = time.perf_counter()
        dataset[0]
        sample_ms = (time.perf_counter() - t0) * 1e3
        print(f"loader: one sample in-process {sample_ms:.1f} ms (decode, "
              "bicubic resize, normalise); "
              f"{cfg.TPU.LOADER_WORKERS} workers, "
              f"{cfg.TPU.ACTIVE_BATCH} images a batch", flush=True)
        forward = make_forward(model)
        w_in, h_in = cfg.INPUT.INPUT_SIZE_TEST
        with torch.no_grad():  # warm-up: first-call cuDNN/allocator cost
            forward(torch.zeros((4, h_in, w_in, 3), device=DEVICE))
        torch.cuda.synchronize()

        profiler = contextlib.nullcontext()
        if args.profile:
            from torch.profiler import ProfilerActivity, profile
            profiler = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
        cuda_radius.launches = 0
        cuda_select.launches = 0
        stages = {}
        with profiler as prof:
            t0 = time.perf_counter()
            stats = region_selection(cfg, model, build_active_loader(cfg), 0,
                                     device=DEVICE, stage_seconds=stages)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {"radius_map": cuda_radius.launches,
                    "greedy_picks": cuda_select.launches}
        n = stats["images"]
        per_img = {k: v / max(n, 1) * 1e3 for k, v in sorted(stages.items())}
        print(f"round 0: {stats}; {wall / max(n, 1) * 1e3:.1f} ms/img wall; "
              "stages ms/img " + json.dumps(
                  {k: round(v, 3) for k, v in per_img.items()}), flush=True)
        print(f"launches on the main path: {launches}", flush=True)
        if args.profile:
            summarize_profile(prof, wall, args.profile)

        budget = cfg.ACTIVE.BUDGET / len(cfg.ACTIVE.SELECT_ITER)
        picks_per_img = math.ceil(1024 * 2048 * budget / 9)
        if n != args.images or stats["picked"] != n * picks_per_img:
            raise AssertionError(f"expected {args.images} images x "
                                 f"{picks_per_img} picks, got {stats}")
        if stats["labeled_px"] <= 0:
            raise AssertionError("the round labeled no pixels")
        for name, count in launches.items():
            if count <= 0:
                raise AssertionError(f"{name} never launched on the path")
            report[name]["launches"] = count
        loader = build_active_loader(cfg, num_workers=0)
        for entry in loader.dataset.data_list:
            mask = load_mask_png(entry["label_mask"])
            ind = load_indicator(entry["indicator"])
            if (mask.shape != (1024, 2048)
                    or ind["selected"].shape != (1024, 2048)
                    or (ind["selected"] & ~ind["active"]).any()
                    or ((mask != 255) & ~ind["selected"]).any()):
                raise AssertionError(f"bad mask/indicator for "
                                     f"{entry['name']}")
        print(f"{n} mask PNGs and indicators written and consistent",
              flush=True)

        # The first image's real outputs against the plain versions.
        batch = next(iter(loader))
        with torch.no_grad():
            logits, embed = forward(torch.as_tensor(batch["img"],
                                                    device=DEVICE))
            if not (torch.isfinite(logits).all() and
                    bool((embed.norm(dim=-1) < 1).all())):
                raise AssertionError("forward outputs not finite / in ball")
            score, _, _ = fused_upsample_region_score(
                logits[0], embed[0], (1024, 2048), score_dtype=torch.bfloat16)
            if not bool(torch.isfinite(score).all()):
                raise AssertionError("score map not finite")
            got = cuda_select.greedy_picks(score, num_picks=picks_per_img,
                                           mask_radius=5)
            want = cuda_select.greedy_picks_reference(
                score, num_picks=picks_per_img, mask_radius=5)
            block = resize_bilinear(embed[0].float(), (1024, 2048))[:128]
            block = block.to(torch.bfloat16).contiguous()
            rad = cuda_radius.radius_map(block)
            rad_plain = cuda_radius.radius_map_reference(block)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError("kernel A differs on the real score map")
        # Near the ball's edge artanh magnifies the float32 rounding of the
        # norm without bound (x1000 at t = 1 - 1e-4), so compare in
        # t = |x| = tanh(r/2) everywhere and hold the relative 1e-6 where
        # t < 0.9 (magnification < 3.2).
        t_diff = float((torch.tanh(rad / 2) - torch.tanh(rad_plain / 2))
                       .abs().max())
        inner = torch.tanh(rad_plain / 2) < 0.9
        rel = (max_rel(torch, rad[inner], rad_plain[inner])
               if bool(inner.any()) else 0.0)
        if rel > 1e-6 or t_diff > 1e-6:
            raise AssertionError(f"kernel B off on the real embedding: "
                                 f"rel {rel}, |t| diff {t_diff}")
        share = float(inner.float().mean())
        print(f"first image: kernel A bit-exact on the real score map; "
              f"kernel B on its first native block: {share:.4f} "
              f"of pixels at t < 0.9 (max rel diff {rel:.3e}), "
              f"max |t| diff {t_diff:.3e}", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--images", type=int, default=8)
    parser.add_argument("--profile", metavar="TRACE.json",
                        help="trace the round with torch.profiler, write "
                        "the chrome trace here and print the device busy "
                        "share and the top kernels")
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (REPO / "halo_tpu_torch").is_dir() or not CONFIG.exists():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}",
          flush=True)

    from halo_tpu_torch import kernels
    t0 = time.perf_counter()
    lib = kernels.build()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in (kernels.BUILD_DIR / "build.log").read_text().splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  ptxas" + line.split("ptxas", 1)[-1], flush=True)
    kernels.load()

    gen = torch.Generator(device=DEVICE).manual_seed(args.seed)
    report = {}
    phase_radius(torch, gen, report)
    phase_select(torch, gen, report)
    phase_slice(torch, args, report)
    print(json.dumps({"kernels": [report["greedy_picks"],
                                  report["radius_map"]]}), flush=True)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
