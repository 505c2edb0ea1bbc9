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
             pre-active block and a tie plateau, an early-stop case, and
             a batch of 4 maps in one launch (one stops early); times
             one map, the batch (us a pick) and the plain version.
  4. conv    kernel C (the dilated 3x3 conv) against its plain version,
             forward and dx through autograd, at the train step's shapes
             (B = 2, 90x160: 256 ch d=2, 512 ch d=2, 512 ch d=4, bf16;
             256 ch d=2 float32), after one small launch synchronised at
             once: bf16 within one bf16 step beyond 1e-5 of max|out|, f32
             within 1e-5 of max|out|; times kernel (fwd and dx), plain
             version, F.conv2d (cuDNN) and its dgrad, and the dk path
             (wgrad_taps) beside cuDNN's wgrad, with the bound of each.
  5. slice   the acquisition round of configs/gtav/source_target.yaml
             (DeepLab-v3+ R101, hyperbolic head with HFR, 640x1280 input,
             entropy x radius, 1% a round) from a seeded random init over a
             synthetic 1024x2048 Cityscapes tree: 2331 picks an image,
             every mask PNG and indicator written, both kernels launched
             on the path (launch counters; kernel A once a batch),
             ms/img by stage; then kernel A held bit-exact (and timed) and
             kernel B within 1e-6 against their plain versions on the
             first image's real score map and embedding.
  6. train   halo_tpu_torch.train.main on the same recipe with
             TPU.DENSE_CONV_MODE pallas (source 2x720x1280, target
             2x640x1280) over synthetic GTAV (1914x1052) and Cityscapes
             trees: round 1 at step 0, 8 train steps, validation on
             2 images, checkpoints. Checks masks, finite losses, moved
             parameters and unchanged FrozenBN buffers, kernel C's
             launches (50 forward + 50 dx a step) and A's and B's, the
             mIoU, last.ckpt loading with strict=True, and kernel C on
             the first step's real layer3/layer4 activations and
             cotangents; prints ms/step (median of steps 3-8), stages and
             peak memory, then ms/step with TPU.DENSE_CONV_MODE conv.
  7. protocols  the pipeline on the same model width with
             TPU.DENSE_CONV_MODE pallas over synthetic SYNTHIA (1280x760,
             16-bit labels) and Cityscapes trees: (a) SYNTHIA source
             pretraining, 3 steps, 16 classes; (b) source_free resumed
             from (a)'s last.ckpt, round 1 at step 0, 3 steps; (c)
             halo_tpu_torch.test.main on (b)'s last.ckpt with
             TEST.SAVE_EMBED over 2 val images: mIoU*, the embed/*.pt
             artifacts, one kernel-B launch a rich-eval batch, kernel C in
             the eval forwards, and the first image's rich radius map
             against the plain dist0 of its embedding; (d) GTAV fully_sup,
             3 steps, no round. Kernel launches are counted around each
             run; each run prints ms/step (or ms/img), loader wait and
             peak memory.
  8. families  the other DeepLab models and the control arm, full width,
             TPU.DENSE_CONV_MODE pallas, launch counts zeroed before and
             read after each run: (e) configs/gtav/ripu.yaml (Euclidean
             v3+, 512 channels, LCR, purity ripu) with MODEL.WEIGHTS a
             torchvision-layout R101 .pth written from --seed: the trunk
             equals the file after the load, round 1 over the 8-image
             Cityscapes tree, 3 steps, then the test entry on 2 val
             images (kernel B f32 at C = 512 on the decoder features,
             held against its plain version and timed); (f)
             deeplabv2_resnet101 with MODEL.HYPER True on the headline
             recipe: round 1 (kernel B on the input-resolution embedding),
             3 steps, the test entry; (g) the random arm: a round with no
             model (no forward, no kernel C), kernel A once a batch, the
             score bits made on the card equal to the CPU's; (h) one
             forward and backward of deeplabv3plus_resnet50, _resnet101
             (also with TPU.REMAT), _resnet152 and _resnext101_32x8d at
             2x640x1280, kernel-C launches by the eligibility rule (8, 25,
             38, 0 convs; a rematerialised block's twice forward).
  9. acdc    the Cityscapes -> ACDC recipes at full width (segformer_mitb4,
             hyperbolic head, 64 reduced channels, no HFR, 1280x640
             inputs), over a synthetic Cityscapes source tree and an ACDC
             tree at 1920x1080 (fog, night, rain, snow; 2 train frames each
             with shared basenames, 2 val frames), MODEL.WEIGHTS an
             NVlabs-layout MiT-B4 .pth written from --seed: (1)
             train.main on configs/acdc/source_target.yaml, round 1 at
             step 0 (2304 picks an image, masks and indicators under the
             nested stems; launches A 2, B 9 an image, C 0), 3 steps,
             validation on 2 images; kernel A bit-exact (and timed) and
             kernel B within 1e-6 on each 128-row block of the first
             image's real 1080x1920 maps, the ragged 56-row block
             included; the SDPA kernels the attention runs; (2)
             halo_tpu_torch.test.main on configs/acdc/test.yaml with the
             run's last.ckpt and TEST.SAVE_EMBED (one kernel-B f32 launch
             a batch, held against the plain dist0); (3) forward and
             backward of segformer_mitb4 at 2x640x1280, with and without
             TPU.REMAT: the median of 3 steps, and the device's busy time
             in a fourth under torch.profiler. Every earlier phase runs at
             its full depth.

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
TRAIN_STEPS = 8  # train steps of the train phase; ms/step is over 3-8
TRUNK_INPUT = (640, 1280)  # phases families (h), acdc (3): the target crop
ACDC_SIZE = (1080, 1920)  # phase acdc: ACDC's native (H, W)
# phase families (h): (trunk, TPU.REMAT, kernel-C convs under the rule)
TRUNKS = (("resnet50", False, 8), ("resnet101", False, 25),
          ("resnet101", True, 25), ("resnet152", False, 38),
          ("resnext101_32x8d", False, 0))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate, the float32
# rate outside the tensor cores and the dense bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12


def bound_ms(nbytes: float, flops: float,
             flop_rate: float = F32_FLOP_PER_S) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Median ms of fn(i) over ``iters`` launches, each between its own
    pair of CUDA events. The launches queue behind a spin kernel of
    ~0.1 s, so the device runs them back to back and a kernel shorter than
    the host's launch gap is timed alone, not with the gap."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(200_000_000)  # clock cycles
    for i, (start, end) in enumerate(events):
        start.record()
        fn(i)
        end.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in events)
    return times[len(times) // 2]


def max_rel(torch, got, want) -> float:
    """Largest |got - want| / |want|; an exact zero must match exactly."""
    diff = (got - want).abs()
    zero = want == 0
    if bool((diff[zero] != 0).any()):
        return math.inf
    return float((diff[~zero] / want[~zero].abs()).max())


def release(torch):
    """Free what a finished run left on the device."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


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


def same_picks(torch, got, want, label):
    """Kernel A's (picks, count) bit-exact with its plain version's."""
    if torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]):
        return
    bad = (got[0] != want[0]).any(dim=-1).nonzero()
    at = bad[0].tolist() if len(bad) else "count"
    raise AssertionError(f"kernel A differs from its plain version on the "
                         f"{label} at {at}: {got[1].tolist()} vs "
                         f"{want[1].tolist()} picks")


def phase_select(torch, gen, report, num_picks=2331, m=5):
    from halo_tpu_torch.active import cuda_select
    kw = dict(num_picks=num_picks, mask_radius=m)
    score = plateau_map(torch, gen, 1024, 2048)
    got = cuda_select.greedy_picks(score, **kw)
    torch.cuda.synchronize()
    same_picks(torch, got, cuda_select.greedy_picks_reference(score, **kw),
               "plateau map")
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
    # A batch of 4 maps in one launch: the plateau map, two random maps
    # and one with 1000 finite scores (it stops early).
    sparse = torch.full((1024, 2048), float("-inf"), device=DEVICE)
    idx = torch.randint(0, 1024 * 2048, (1000,), generator=gen,
                        device=DEVICE)
    sparse.view(-1)[idx] = torch.rand((1000,), generator=gen, device=DEVICE)
    maps = torch.stack([score, torch.randn((1024, 2048), generator=gen,
                                           device=DEVICE),
                        score.flip(1), sparse])
    picks, counts = cuda_select.greedy_picks(maps, **kw)
    for i in range(4):
        same_picks(torch, (picks[i], counts[i]),
                   cuda_select.greedy_picks_reference(maps[i], **kw),
                   f"batch map {i}")
    print(f"select batch of 4 maps: bit-exact, {counts.tolist()} picks",
          flush=True)
    ms = cuda_ms(torch, lambda i: cuda_select.greedy_picks(score, **kw), 5,
                 warmup=1)
    ms4 = cuda_ms(torch, lambda i: cuda_select.greedy_picks(maps, **kw), 5,
                  warmup=1)
    t0 = time.perf_counter()
    cuda_select.greedy_picks_reference(score, **kw)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    b_ms, b_by = bound_ms(1024 * 2048 * 4 + num_picks * 2 * 4 + 4,
                          1024 * 2048 + n * (2 * m + 1) * 1024)
    print(f"select 1024x2048 N={num_picks}: kernel {ms:.3f} ms "
          f"({ms / num_picks * 1e3:.3f} us/pick), plain {plain:.1f} ms, "
          f"bound {b_ms:.4f} ms; batch of 4 maps in one launch {ms4:.3f} ms "
          f"({ms4 / num_picks * 1e3:.3f} us a pick of each map's chain, "
          f"{ms4 / ms:.2f}x one map)", flush=True)
    report["greedy_picks"] = {
        "name": "greedy_picks", "route": "cuda",
        "source": "halo_tpu_torch/csrc/select.cu",
        "replaces": "halo_tpu/active/pallas_select.py:119",
        "launches": 0, "max_abs_err": 0.0, "ms": ms, "plain_ms": plain,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def bf16_steps(torch, got, want) -> tuple:
    """(largest |got - want| in bf16 steps of the larger magnitude, the same
    after forgiving 1e-5 of max|want|): near zero the order of the float32
    sums decides which way a bf16 output rounds."""
    got, want = got.float(), want.float()
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(2.0 ** -126)
    step = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    diff = (got - want).abs()
    floor = 1e-5 * float(want.abs().max())
    return (float((diff / step).max()),
            float(((diff - floor).clamp_min(0) / step).max()))


def check_conv(torch, dc, x, wt, g, d, label) -> float:
    """Kernel C's forward and dx against the plain version (dx through
    autograd of each); returns the largest absolute difference. bf16: at
    most one bf16 step apart beyond 1e-5 of max|out|; f32: within 1e-5 of
    max|out|."""
    xk = x.detach().clone().requires_grad_(True)
    got = dc.dilated_conv3x3(xk, wt, d)
    got.backward(g)
    xp = x.detach().clone().requires_grad_(True)
    want = dc.dilated_conv3x3_plain(xp, wt, d)
    want.backward(g)
    torch.cuda.synchronize()
    worst = 0.0
    for part, a, e in (("fwd", got, want), ("dx", xk.grad, xp.grad)):
        a, e = a.detach(), e.detach()
        err = float((a.float() - e.float()).abs().max())
        worst = max(worst, err)
        if x.dtype == torch.bfloat16:
            strict, floored = bf16_steps(torch, a, e)
            ok = floored <= 1.0
            detail = (f"{strict:.2f} bf16 steps ({floored:.2f} beyond "
                      "1e-5 of max|out|)")
        else:
            rel = err / float(e.float().abs().max())
            ok = rel <= 1e-5
            detail = f"{rel:.2e} of max|out|"
        print(f"conv {label} {part}: max abs diff {err:.3e}, {detail}",
              flush=True)
        if not ok:
            raise AssertionError(f"kernel C {part} off its plain version "
                                 f"at {label}: {detail}")
    return worst


def phase_conv(torch, gen, report):
    """Kernel C at the main path's shapes (B = 2, 90x160) against its plain
    version, forward and dx; times kernel, plain version and cuDNN."""
    import torch.nn.functional as F
    from halo_tpu_torch.ops import dilated_conv as dc

    cases = [(256, 2, torch.bfloat16), (512, 2, torch.bfloat16),
             (512, 4, torch.bfloat16), (256, 2, torch.float32)]
    # One launch, synchronised at once: a kernel that hangs or faults
    # shows here, not in a later phase.
    x = torch.randn((1, 64, 8, 40), generator=gen, device=DEVICE)
    x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    dc._conv(x, torch.zeros((64, 64, 3, 3), dtype=torch.bfloat16,
                            device=DEVICE), 1, "fwd")
    torch.cuda.synchronize()
    print("conv: first bf16 launch ran", flush=True)
    worst = 0.0
    rows = {}
    for c, d, dtype in cases:
        label = f"{c}ch d={d} {str(dtype).split('.')[-1]}"
        x = torch.randn((2, c, 90, 160), generator=gen, device=DEVICE)
        x = x.to(dtype).contiguous(memory_format=torch.channels_last)
        wt = (torch.randn((c, c, 3, 3), generator=gen, device=DEVICE)
              / math.sqrt(9 * c)).to(dtype)
        g = torch.randn((2, c, 90, 160), generator=gen, device=DEVICE)
        g = g.to(dtype).contiguous(memory_format=torch.channels_last)
        worst = max(worst, check_conv(torch, dc, x, wt, g, d, label))
        wt_cl = wt.contiguous(memory_format=torch.channels_last)
        wT = wt.flip(2, 3).transpose(0, 1)
        with torch.no_grad():
            ms = cuda_ms(torch, lambda i: dc._conv(x, wt, d, "fwd"), 50)
            ms_dx = cuda_ms(torch, lambda i: dc._conv(g, wT, d, "dx"), 50)
            plain = cuda_ms(
                torch, lambda i: dc.dilated_conv3x3_plain(x, wt, d), 10)
            lib = cuda_ms(torch, lambda i: F.conv2d(
                x, wt_cl, padding=d, dilation=d), 50)
            lib_dx = cuda_ms(torch, lambda i: torch.nn.grad.conv2d_input(
                x.shape, wt_cl, g, padding=d, dilation=d), 50)
            dk = cuda_ms(torch, lambda i: dc.wgrad_taps(x, g, d), 20)
            lib_dk = cuda_ms(torch, lambda i: torch.nn.grad.conv2d_weight(
                x, wt.shape, g, padding=d, dilation=d), 20)
        flops = 2 * 2 * 90 * 160 * 9 * c * c
        nbytes = (2 * 2 * 90 * 160 * c + 9 * c * c) * x.element_size()
        rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S
        b_ms, b_by = bound_ms(nbytes, flops, rate)
        # dk reads x and the cotangent once and writes the 9 taps
        dk_ms, dk_by = bound_ms((2 * 2 * 2 * 90 * 160 * c + 9 * c * c)
                                * x.element_size(), flops, rate)
        print(f"conv {label} (2, {c}, 90, 160): kernel fwd {ms:.4f} ms, dx "
              f"{ms_dx:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s fwd), plain "
              f"{plain:.4f} ms, F.conv2d (cuDNN, channels_last) {lib:.4f} "
              f"ms, cuDNN dgrad (conv2d_input) {lib_dx:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}); dk (wgrad_taps: pad, 9 slab copies, "
              f"9 torch.mm) {dk:.4f} ms, cuDNN wgrad (conv2d_weight) "
              f"{lib_dk:.4f} ms, dk bound {dk_ms:.4f} ms ({dk_by})",
              flush=True)
        rows[label] = (ms, plain, b_ms, b_by, lib)
    ms, plain, b_ms, b_by, lib = rows["256ch d=2 bfloat16"]
    report["dilated_conv3x3"] = {
        "name": "dilated_conv3x3", "route": "cuda",
        "source": "halo_tpu_torch/csrc/dilated_conv.cu",
        "replaces": "halo_tpu/ops/pallas_conv.py:150",
        "launches": 0, "max_abs_err": worst, "ms": ms, "plain_ms": plain,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}


def write_cityscapes(root: Path, n_images: int, seed: int,
                     split: str = "train"):
    """A synthetic Cityscapes split of 1024x2048 images: blocky random
    colours and label ids (16x16 blocks), from ``seed``; writes
    ``cityscapes_<split>_list.txt``."""
    import numpy as np
    from PIL import Image
    from halo_tpu_torch.data.datasets import ID_TO_TRAINID_19

    rng = np.random.default_rng(seed)
    ids = np.array(list(ID_TO_TRAINID_19) + [0], np.uint8)
    names = []
    for i in range(n_images):
        name = f"city{i}/city{i}_{i:06d}_000019_leftImg8bit.png"
        stem = name.split("_leftImg8bit")[0]
        img_p = root / "cityscapes" / "leftImg8bit" / split / name
        lab_p = (root / "cityscapes" / "gtFine" / split
                 / f"{stem}_gtFine_labelIds.png")
        img_p.parent.mkdir(parents=True, exist_ok=True)
        lab_p.parent.mkdir(parents=True, exist_ok=True)
        img = rng.integers(0, 256, (64, 128, 3), np.uint8)
        lab = rng.choice(ids, (64, 128))
        Image.fromarray(img.repeat(16, 0).repeat(16, 1)).save(img_p)
        Image.fromarray(lab.repeat(16, 0).repeat(16, 1)).save(lab_p)
        names.append(name)
    (root / f"cityscapes_{split}_list.txt").write_text("\n".join(names)
                                                        + "\n")


def write_gtav(root: Path, n_images: int, seed: int):
    """A synthetic GTAV tree of 1052x1914 images and label ids (blocks of
    2x2 pixels) with its own class-frequency table, ``gtav_label_info.p``,
    from ``seed``."""
    import pickle

    import numpy as np
    from PIL import Image
    from halo_tpu_torch.data.datasets import ID_TO_TRAINID_19

    rng = np.random.default_rng(seed)
    ids = np.array(list(ID_TO_TRAINID_19), np.uint8)
    gtav = root / "gtav"
    (gtav / "images").mkdir(parents=True, exist_ok=True)
    (gtav / "labels").mkdir(parents=True, exist_ok=True)
    names, file_to_label = [], {}
    for i in range(n_images):
        name = f"{i:05d}.png"
        img = rng.integers(0, 256, (526, 957, 3), np.uint8)
        lab = rng.choice(ids, (526, 957))
        Image.fromarray(img.repeat(2, 0).repeat(2, 1)).save(
            gtav / "images" / name)
        Image.fromarray(lab.repeat(2, 0).repeat(2, 1)).save(
            gtav / "labels" / name)
        names.append(name)
        file_to_label[name] = sorted(
            ID_TO_TRAINID_19[int(v)] for v in np.unique(lab))
    label_to_file = [[n for n in names if c in file_to_label[n]]
                     for c in range(19)]
    with open(gtav / "gtav_label_info.p", "wb") as f:
        pickle.dump((label_to_file, file_to_label), f)
    (root / "gtav_train_list.txt").write_text("\n".join(names) + "\n")


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
        batches = math.ceil(n / int(cfg.TPU.ACTIVE_BATCH))
        if launches["greedy_picks"] != batches:
            raise AssertionError(f"kernel A launched {launches['greedy_picks']}"
                                 f" times for {batches} batches of one size")
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
        same_picks(torch, got, want, "real score map")
        kw = dict(num_picks=picks_per_img, mask_radius=5)
        ms = cuda_ms(torch, lambda i: cuda_select.greedy_picks(score, **kw),
                     5, warmup=1)
        print(f"kernel A on the first image's real score map: {ms:.3f} ms "
              f"({ms / picks_per_img * 1e3:.3f} us/pick)", flush=True)
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


def profile_steps(torch, learner, path: str, steps: int = 3):
    """Device time of ``steps`` train steps on one fixed batch (no loader),
    traced with torch.profiler; the trace goes next to ``path``."""
    from torch.profiler import ProfilerActivity, profile
    mode = learner.cfg.TPU.DENSE_CONV_MODE
    loaders = learner.train_loaders()
    batches = {k: learner._to_device(next(iter(v)))
               for k, v in loaders.items()}
    learner.train_step(batches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            learner.train_step(batches)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(f"profile: {steps} train steps ({mode}) on a fixed batch, "
          f"{wall / steps * 1e3:.1f} ms/step", flush=True)
    summarize_profile(prof, wall, str(Path(path).with_suffix(
        f".train_{mode}.json")))


def phase_train(torch, args, report):
    """The source_target learner through halo_tpu_torch.train.main: round 1
    at step 0, ``TRAIN_STEPS`` train steps, validation, checkpoints; then
    the same steps with cuDNN convs for comparison."""
    import statistics

    from halo_tpu_torch import train
    from halo_tpu_torch.active import cuda_radius, cuda_select
    from halo_tpu_torch.data import mask_cache
    from halo_tpu_torch.data.masks import load_indicator, load_mask_png
    from halo_tpu_torch.engine.state import load_state_dict_file
    from halo_tpu_torch.models import build_segmentor
    from halo_tpu_torch.models.layers import (DilatedConv3x3,
                                              FrozenBatchNorm2d)
    from halo_tpu_torch.ops import dilated_conv as dc

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        data = root / "datasets"
        t0 = time.perf_counter()
        write_gtav(data, 4, args.seed)
        write_cityscapes(data, args.images, args.seed)
        write_cityscapes(data, 2, args.seed + 1, split="val")
        print(f"train setup (synthetic GTAV and Cityscapes trees): "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        def argv(mode, steps, select, val, out):
            return ["-cfg", str(CONFIG), "TPU.DENSE_CONV_MODE", mode,
                    "MODEL.WEIGHTS", "", "resume", "",
                    "ACTIVE.SELECT_ITER", select,
                    "SOLVER.NUM_ITER", str(steps),
                    "TPU.VAL_INTERVAL", str(val),
                    "TPU.DATASET_DIR", str(data),
                    "OUTPUT_DIR", str(root / out), "SEED", str(args.seed)]

        captured = {}

        def capture(module, inputs, output):
            """The first train-mode call of a layer3 and a layer4 kernel-C
            conv: its input, weight and (by a tensor hook) cotangent."""
            if not (isinstance(module, DilatedConv3x3) and module.training
                    and torch.is_grad_enabled()
                    and module.in_channels not in captured):
                return
            entry = {"x": inputs[0].detach().to(torch.bfloat16).clone(),
                     "w": module.weight.detach().to(torch.bfloat16).clone(),
                     "d": module.dilation[0]}
            captured[module.in_channels] = entry
            output.register_hook(
                lambda g: entry.__setitem__("g", g.detach().clone()))

        handle = torch.nn.modules.module.register_module_forward_hook(
            capture)
        mask_cache.clear()
        stages = {}
        torch.cuda.reset_peak_memory_stats()
        dc.launches_fwd = dc.launches_dx = dc.layout_copies = 0
        cuda_radius.launches = cuda_select.launches = 0
        t0 = time.perf_counter()
        try:
            learner = train.main(argv("pallas", TRAIN_STEPS, "[0]",
                                      TRAIN_STEPS, "out"),
                                 device=DEVICE, stage_seconds=stages)
            torch.cuda.synchronize()
        finally:
            handle.remove()
        wall = time.perf_counter() - t0
        counts = {"fwd": dc.launches_fwd, "dx": dc.launches_dx,
                  "layout_copies": dc.layout_copies,
                  "radius_map": cuda_radius.launches,
                  "greedy_picks": cuda_select.launches}
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        cfg = learner.cfg
        print(f"train main path: {counts} launches in {wall:.1f} s; peak "
              f"device memory {peak_gib:.2f} GiB", flush=True)

        # Round 1: every mask and indicator written and consistent.
        entries = learner.active_loader.dataset.data_list
        for entry in entries:
            mask = load_mask_png(entry["label_mask"])
            ind = load_indicator(entry["indicator"])
            if (mask.shape != (1024, 2048)
                    or ind["selected"].shape != (1024, 2048)
                    or (ind["selected"] & ~ind["active"]).any()
                    or ((mask != 255) & ~ind["selected"]).any()
                    or not (mask != 255).any()):
                raise AssertionError(f"round 1: bad mask/indicator for "
                                     f"{entry['name']}")
        # The steps: finite loss terms.
        hist = learner.history
        if len(hist) != TRAIN_STEPS or not all(
                math.isfinite(v) for rec in hist for k, v in rec.items()
                if k.startswith(("loss", "negative"))):
            raise AssertionError(f"train steps: {hist}")
        print("losses: " + json.dumps(
            [{k: round(v, 5) for k, v in rec.items()
              if k.startswith(("loss", "negative"))} for rec in hist]),
            flush=True)
        # Every trainable parameter moved; every FrozenBN buffer did not.
        before = load_state_dict_file(str(Path(cfg.SAVE_DIR)
                                          / "model_before_round_1.ckpt"))
        after = learner.model.state_dict()
        still = [n for n, p in learner.model.named_parameters()
                 if p.requires_grad and torch.equal(before[n],
                                                    after[n].cpu())]
        frozen = [n for n, m in learner.model.named_modules()
                  if isinstance(m, FrozenBatchNorm2d)]
        moved_buffers = [f"{n}.{b}" for n in frozen
                         for b in ("weight", "bias", "running_mean",
                                   "running_var")
                         if not torch.equal(before[f"{n}.{b}"],
                                            after[f"{n}.{b}"].cpu())]
        n_params = sum(1 for p in learner.model.parameters()
                       if p.requires_grad)
        print(f"parameters moved: {n_params - len(still)} of {n_params}; "
              f"FrozenBN buffers changed: {len(moved_buffers)} of "
              f"{4 * len(frozen)}", flush=True)
        if still or moved_buffers:
            raise AssertionError(f"unmoved parameters {still[:5]}, changed "
                                 f"FrozenBN buffers {moved_buffers[:5]}")
        # Kernel C: 25 convs, forward and dx, in each of a step's two
        # forwards; the round's and validation's forwards add 25 each.
        n_conv = sum(isinstance(m, DilatedConv3x3)
                     for m in learner.model.modules())
        round_fwd = math.ceil(len(entries) / int(cfg.TPU.ACTIVE_BATCH))
        val_fwd = 2
        want_dx = 2 * n_conv * TRAIN_STEPS
        want_fwd = want_dx + n_conv * (round_fwd + val_fwd)
        print(f"kernel C: {n_conv} convs; {counts['fwd']} forward launches "
              f"(want {want_fwd}: {2 * n_conv} a step + {n_conv} for each "
              f"of {round_fwd} sweep and {val_fwd} validation forwards), "
              f"{counts['dx']} dx (want {want_dx}: {2 * n_conv} a step); "
              f"layout copies {counts['layout_copies'] / TRAIN_STEPS:.1f} "
              "a step", flush=True)
        if (n_conv != 25 or counts["fwd"] != want_fwd
                or counts["dx"] != want_dx or counts["radius_map"] <= 0
                or counts["greedy_picks"] <= 0):
            raise AssertionError(f"kernel launches on the train path: "
                                 f"{counts}")
        report["dilated_conv3x3"]["launches"] = counts["fwd"] + counts["dx"]
        # Validation and the checkpoint.
        if not (math.isfinite(learner.best_miou) and learner.best_miou >= 0):
            raise AssertionError(f"validation mIoU {learner.best_miou}")
        fresh = build_segmentor(cfg, device=DEVICE)
        fresh.load_state_dict(load_state_dict_file(
            str(Path(cfg.SAVE_DIR) / "last.ckpt")), strict=True)
        if not all(torch.equal(v, after[k])
                   for k, v in fresh.state_dict().items()):
            raise AssertionError("last.ckpt does not hold the final model")
        print(f"validation mIoU {learner.best_miou:.4f} over 2 images; "
              "last.ckpt loads back with strict=True", flush=True)
        # Kernel C on the first step's real tensors.
        worst = max(check_conv(torch, dc, e["x"], e["w"], e["g"], e["d"],
                               f"train step 0, {name} conv2")
                    for name, e in (("layer3", captured[256]),
                                    ("layer4", captured[512])))
        report["dilated_conv3x3"]["max_abs_err"] = max(
            report["dilated_conv3x3"]["max_abs_err"], worst)

        step_ms = [(a + b) * 1e3 for a, b in learner.step_seconds]
        load_ms = [a * 1e3 for a, _ in learner.step_seconds]
        n = len(step_ms)
        print(f"train ms/step (pallas, kernel C): median of steps 3-{n} "
              f"{statistics.median(step_ms[2:]):.1f} (loader wait "
              f"{statistics.median(load_ms[2:]):.1f}), of steps 2-4 "
              f"{statistics.median(step_ms[1:4]):.1f}; each step (load, "
              "step) ms " + json.dumps([(round(a * 1e3, 1), round(b * 1e3, 1))
                                       for a, b in learner.step_seconds]),
              flush=True)
        print("train stages, s over the run: " + json.dumps(
            {k: round(v, 3) for k, v in stages.items()}), flush=True)
        if args.profile:
            profile_steps(torch, learner, args.profile)
        del learner, fresh, captured, before, after
        release(torch)

        torch.cuda.reset_peak_memory_stats()
        stages_conv = {}
        learner = train.main(argv("conv", 4, "[]", 0, "out_conv"),
                             device=DEVICE, stage_seconds=stages_conv)
        torch.cuda.synchronize()
        step_ms = [(a + b) * 1e3 for a, b in learner.step_seconds]
        load_ms = [a * 1e3 for a, _ in learner.step_seconds]
        print(f"train ms/step (conv, cuDNN): median of steps 2-4 "
              f"{statistics.median(step_ms[1:4]):.1f} (loader wait "
              f"{statistics.median(load_ms[1:4]):.1f}); each step (load, "
              "step) ms " + json.dumps([(round(a * 1e3, 1), round(b * 1e3, 1))
                                       for a, b in learner.step_seconds])
              + f"; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
              "stages " + json.dumps(
                  {k: round(v, 3) for k, v in stages_conv.items()}),
              flush=True)
        if args.profile:
            profile_steps(torch, learner, args.profile)
        del learner
        release(torch)


def write_synthia(root: Path, n_images: int, seed: int):
    """A synthetic SYNTHIA tree at the set's native 1280x760: images and
    16-bit label-id PNGs under ``GT/LABELS`` (blocks of 8x8 pixels) with
    the class-frequency table ``synthia_label_info.p``, from ``seed``."""
    import pickle

    import numpy as np
    from PIL import Image
    from halo_tpu_torch.data.datasets import ID_TO_TRAINID_16

    rng = np.random.default_rng(seed)
    ids = np.array(list(ID_TO_TRAINID_16) + [0], np.uint16)
    syn = root / "synthia"
    (syn / "images").mkdir(parents=True, exist_ok=True)
    (syn / "GT" / "LABELS").mkdir(parents=True, exist_ok=True)
    names, file_to_label = [], {}
    for i in range(n_images):
        name = f"{i:07d}.png"
        img = rng.integers(0, 256, (95, 160, 3), np.uint8)
        lab = rng.choice(ids, (95, 160))
        Image.fromarray(img.repeat(8, 0).repeat(8, 1)).save(
            syn / "images" / name)
        Image.fromarray(lab.repeat(8, 0).repeat(8, 1)).save(
            syn / "GT" / "LABELS" / name)
        names.append(name)
        file_to_label[name] = sorted(ID_TO_TRAINID_16[int(v)]
                                     for v in np.unique(lab)
                                     if int(v) in ID_TO_TRAINID_16)
    label_to_file = [[n for n in names if c in file_to_label[n]]
                     for c in range(16)]
    with open(syn / "synthia_label_info.p", "wb") as f:
        pickle.dump((label_to_file, file_to_label), f)
    (root / "synthia_train_list.txt").write_text("\n".join(names) + "\n")


def phase_protocols(torch, args, report):
    """The pipeline: SYNTHIA source -> source_free resumed from it -> the
    test entry with the rich eval; then GTAV fully_sup. Each run is driven
    with every launch counter at 0 and read at once after it."""
    import statistics

    from halo_tpu_torch import test as test_entry
    from halo_tpu_torch import train
    from halo_tpu_torch.active import cuda_radius, cuda_select
    from halo_tpu_torch.data import mask_cache
    from halo_tpu_torch.engine import learners
    from halo_tpu_torch.engine.state import load_state_dict_file
    from halo_tpu_torch.models.layers import DilatedConv3x3
    from halo_tpu_torch.ops import dilated_conv as dc
    from halo_tpu_torch.ops.resize import resize_bilinear

    card = card_line()
    steps = 3

    def counts():
        return {"fwd": dc.launches_fwd, "dx": dc.launches_dx,
                "radius_map": cuda_radius.launches,
                "greedy_picks": cuda_select.launches}

    def zero_counts():
        dc.launches_fwd = dc.launches_dx = dc.layout_copies = 0
        cuda_radius.launches = cuda_select.launches = 0

    def expect(label, got, want):
        if got != want:
            raise AssertionError(f"{label}: launches {got}, want {want}")
        print(f"{label}: launches {got}", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        data = root / "datasets"
        t0 = time.perf_counter()
        write_synthia(data, 4, args.seed)
        write_cityscapes(data, args.images, args.seed)
        write_cityscapes(data, 2, args.seed + 1, split="val")
        print(f"protocols setup (synthetic SYNTHIA and Cityscapes trees): "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        def argv(recipe, name, resume="", *extra):
            return ["-cfg", str(REPO / "configs" / recipe),
                    "TPU.DENSE_CONV_MODE", "pallas", "MODEL.WEIGHTS", "",
                    "resume", resume, "SOLVER.NUM_ITER", str(steps),
                    "TPU.VAL_INTERVAL", "0", "TPU.DATASET_DIR", str(data),
                    "OUTPUT_DIR", str(root / "out"), "NAME", name,
                    "SEED", str(args.seed), *extra]

        def run_train(label, recipe, name, resume="", *extra):
            mask_cache.clear()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            t0 = time.perf_counter()
            learner = train.main(argv(recipe, name, resume, *extra),
                                 device=DEVICE, stage_seconds={})
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = counts()
            hist = learner.history
            if len(hist) != steps or not all(
                    math.isfinite(v) for rec in hist for k, v in rec.items()
                    if k.startswith(("loss", "negative"))):
                raise AssertionError(f"{label}: {hist}")
            step_ms = [(a + b) * 1e3 for a, b in learner.step_seconds]
            load_ms = [a * 1e3 for a, _ in learner.step_seconds]
            print(f"{label} ({learner.protocol}, "
                  f"{learner.cfg.MODEL.NUM_CLASSES} classes): ms/step median "
                  f"of steps 2-{steps} {statistics.median(step_ms[1:]):.1f} "
                  f"(loader wait {statistics.median(load_ms[1:]):.1f}); "
                  f"each step {json.dumps([round(v, 1) for v in step_ms])}; "
                  f"peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
                  f"run {wall:.1f} s; {card}", flush=True)
            print(f"{label} losses: " + json.dumps(
                [{k: round(v, 5) for k, v in rec.items()
                  if k.startswith(("loss", "negative", "consistency"))}
                 for rec in hist]), flush=True)
            return learner, got

        src, got = run_train("(a) source", "synthia/source_only.yaml",
                             "source")
        n_conv = sum(isinstance(m, DilatedConv3x3)
                     for m in src.model.modules())
        if n_conv != 25:
            raise AssertionError(f"{n_conv} kernel-C convs, want 25")
        expect("(a) source", got, {"fwd": n_conv * steps,
                                   "dx": n_conv * steps, "radius_map": 0,
                                   "greedy_picks": 0})
        src_ckpt = str(Path(src.cfg.SAVE_DIR) / "last.ckpt")
        del src
        release(torch)

        sf, got = run_train("(b) source_free", "synthia/source_free.yaml",
                            "source_free", src_ckpt,
                            "ACTIVE.SELECT_ITER", "[0]")
        batches = math.ceil(args.images / int(sf.cfg.TPU.ACTIVE_BATCH))
        if got["radius_map"] <= 0:
            raise AssertionError(f"(b) kernel B never launched: {got}")
        expect("(b) source_free", got, {
            "fwd": n_conv * (steps + batches), "dx": n_conv * steps,
            "radius_map": got["radius_map"], "greedy_picks": batches})
        if sf.active_round != 2:
            raise AssertionError(f"(b) rounds: {sf.active_round - 1}")
        # round 1 ran on (a)'s weights: the resume took
        before = load_state_dict_file(str(Path(sf.cfg.SAVE_DIR)
                                          / "model_before_round_1.ckpt"))
        if not all(torch.equal(v, before[k]) for k, v in
                   load_state_dict_file(src_ckpt).items()):
            raise AssertionError("(b) did not start from (a)'s last.ckpt")
        del before
        sf_ckpt = str(Path(sf.cfg.SAVE_DIR) / "last.ckpt")
        del sf
        release(torch)

        # (c) the test entry; the rich step is wrapped to keep the first
        # batch's outputs and to time each call between synchronisations.
        make_rich = learners.make_rich_eval_step
        kept, call_ms, test_cfg = [], [], []

        def timed_rich(cfg, model):
            step = make_rich(cfg, model)
            test_cfg.append(cfg)

            def run(img, label, flip=True):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(img, label, flip=flip)
                torch.cuda.synchronize()
                call_ms.append((time.perf_counter() - t0) * 1e3)
                if not kept:
                    kept.append(out)
                return out

            return run

        learners.make_rich_eval_step = timed_rich
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        try:
            result = test_entry.main(
                argv("synthia/test.yaml", "test", sf_ckpt,
                     "TEST.SAVE_EMBED", "True"), device=DEVICE)
            torch.cuda.synchronize()
        finally:
            learners.make_rich_eval_step = make_rich
        wall = time.perf_counter() - t0
        got = counts()
        n_val = len(call_ms)
        expect("(c) test", got, {"fwd": n_conv * n_val, "dx": 0,
                                 "radius_map": n_val, "greedy_picks": 0})
        if n_val != 2 or not ({"mIoU", "mAcc", "aAcc", "iou_class",
                               "mIoU*"} <= set(result)) or not all(
                math.isfinite(v) for v in (result["mIoU"], result["mIoU*"])):
            raise AssertionError(f"(c) test result {result}, {n_val} batches")
        embed_dir = root / "out" / "test" / "embed"
        arts = sorted(embed_dir.glob("*.pt"))
        if len(arts) != 2:
            raise AssertionError(f"(c) artifacts {arts}")
        # the embedding is the decoder's, at a quarter of the input size
        w_in, h_in = test_cfg[0].INPUT.INPUT_SIZE_TEST
        for path in arts:
            blob = torch.load(path, weights_only=False)
            shapes = {k: (str(v.dtype).split(".")[-1], tuple(v.shape))
                      for k, v in blob.items()}
            want = {"label": ("int32", (1, 1024, 2048)),
                    "pred": ("int32", (1, 1024, 2048)),
                    "output": ("float32", (1, 1024, 2048, 16)),
                    "embed": ("float32", (1, h_in // 4, w_in // 4, 64))}
            if shapes != want:
                raise AssertionError(f"(c) {path.name}: {shapes}")
        print(f"(c) test: mIoU {result['mIoU']:.4f}, mIoU* "
              f"{result['mIoU*']:.4f} over {n_val} images; rich eval "
              f"ms/img {json.dumps([round(v, 2) for v in call_ms])} "
              f"(entry {wall:.1f} s with model build and resume); peak "
              f"device memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
              f"artifacts {[p.name for p in arts]} with the JAX keys, "
              f"dtypes and shapes; {card}", flush=True)
        # The first image's rich radius map against the plain dist0 of
        # the same embedding; t = tanh(r/2) near the ball's edge.
        r = kept[0]
        size = tuple(r["radius"].shape[1:3])
        plain = resize_bilinear(cuda_radius.radius_map_reference(
            r["embed"])[..., None], size)[..., 0]
        t_diff = float((torch.tanh(r["radius"] / 2)
                        - torch.tanh(plain / 2)).abs().max())
        inner = torch.tanh(plain / 2) < 0.9
        rel = (max_rel(torch, r["radius"][inner], plain[inner])
               if bool(inner.any()) else 0.0)
        if rel > 1e-6 or t_diff > 1e-6:
            raise AssertionError(f"(c) rich radius off the plain dist0: "
                                 f"rel {rel}, |t| diff {t_diff}")
        emb = r["embed"]
        direct = cuda_radius.radius_map(emb)
        err = float((direct - cuda_radius.radius_map_reference(
            emb)).abs().max())
        # the embedding (13 MB) stays in L2 across these launches
        ms = cuda_ms(torch, lambda i: cuda_radius.radius_map(emb), 64)
        plain_ms = cuda_ms(
            torch, lambda i: cuda_radius.radius_map_reference(emb), 16)
        n = emb.numel() // emb.shape[-1]
        b_ms, b_by = bound_ms(emb.numel() * 4 + n * 4, emb.numel() * 2)
        print(f"(c) rich radius map {tuple(r['radius'].shape)} vs plain "
              f"dist0: {float(inner.float().mean()):.4f} of pixels at "
              f"t < 0.9 (max rel diff {rel:.3e}), max |t| diff "
              f"{t_diff:.3e}; kernel B f32 on the {tuple(emb.shape)} "
              f"embedding: max abs diff {err:.3e}, {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})",
              flush=True)
        del kept, r, emb, direct, plain
        release(torch)

        fs, got = run_train("(d) fully_sup", "gtav/fully_sup.yaml",
                            "fully_sup")
        expect("(d) fully_sup", got, {"fwd": 2 * n_conv * steps,
                                      "dx": 2 * n_conv * steps,
                                      "radius_map": 0, "greedy_picks": 0})
        if "consistency_loss" in fs.history[0] or fs.active_iters:
            raise AssertionError(f"(d) fully_sup: {fs.history[0]}")
        del fs
        release(torch)


def write_torchvision_trunk(torch, path: Path, arch: str, seed: int):
    """A seeded torchvision-layout ``state_dict`` of ``arch`` (with the
    ImageNet ``fc.*`` and BatchNorm counters) at ``path``: He-scaled conv
    kernels, BatchNorm statistics near identity, and each block's last
    BatchNorm scale in [0, 0.2), as a trained trunk has it, so the residual
    stream stays bounded over 100 layers. Returns it."""
    from halo_tpu_torch.config import get_default_cfg
    from halo_tpu_torch.models import build_segmentor

    cfg = get_default_cfg()
    cfg.MODEL.NAME = f"deeplabv3plus_{arch}"
    cfg.MODEL.FREEZE_BN = False   # live BN: its counters are in the keys
    with torch.device("meta"):
        keys = build_segmentor(cfg, device="meta").feature_extractor.\
            backbone.state_dict()
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in keys.items():
        shape = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(100)
        elif len(shape) == 4:
            std = math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
            sd[k] = torch.randn(shape, generator=gen) * std
        elif k.endswith(("bn3.weight", "downsample.1.weight")):
            sd[k] = torch.rand(shape, generator=gen) * 0.2
        elif k.endswith(("running_var", "weight")):
            sd[k] = torch.rand(shape, generator=gen) + 0.5
        else:
            sd[k] = torch.randn(shape, generator=gen) * 0.1
    sd["fc.weight"] = torch.zeros(1000, 2048)
    sd["fc.bias"] = torch.zeros(1000)
    torch.save(sd, path)
    return sd


def phase_families(torch, args, report):
    """The other DeepLab models and the random control arm: (e) RIPU with a
    pretrained trunk file, (f) DeepLab-v2 hyperbolic, each through round
    1, 3 train steps and the test entry; (g) the random arm's round; (h)
    forward and backward of the other trunks. Launch counters are zeroed
    before each run and read at once after it."""
    import statistics

    from halo_tpu_torch import test as test_entry
    from halo_tpu_torch import train
    from halo_tpu_torch.active import cuda_radius, cuda_select
    from halo_tpu_torch.active.region_selection import (random_arm_seed,
                                                        region_selection)
    from halo_tpu_torch.config import get_default_cfg
    from halo_tpu_torch.data import mask_cache
    from halo_tpu_torch.data.build import build_active_loader
    from halo_tpu_torch.data.catalog import DatasetCatalog
    from halo_tpu_torch.engine import learners, make_forward
    from halo_tpu_torch.engine.state import load_state_dict_file
    from halo_tpu_torch.losses import cross_entropy_loss
    from halo_tpu_torch.models import build_segmentor
    from halo_tpu_torch.models.layers import DilatedConv3x3
    from halo_tpu_torch.ops import dilated_conv as dc
    from halo_tpu_torch.ops import prng

    card = card_line()
    steps = 3

    def counts():
        return {"fwd": dc.launches_fwd, "dx": dc.launches_dx,
                "radius_map": cuda_radius.launches,
                "greedy_picks": cuda_select.launches}

    def zero_counts():
        dc.launches_fwd = dc.launches_dx = dc.layout_copies = 0
        cuda_radius.launches = cuda_select.launches = 0

    def expect(label, got, want):
        if got != want:
            raise AssertionError(f"{label}: launches {got}, want {want}")
        print(f"{label}: launches {got}", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        data = root / "datasets"
        t0 = time.perf_counter()
        write_gtav(data, 4, args.seed)
        write_cityscapes(data, args.images, args.seed)
        write_cityscapes(data, 2, args.seed + 1, split="val")
        weights = root / "resnet101_torchvision.pth"
        trunk_file = write_torchvision_trunk(torch, weights, "resnet101",
                                             args.seed)
        print(f"families setup (synthetic GTAV and Cityscapes trees, "
              f"torchvision-layout R101 file): "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        batches = math.ceil(args.images / 4)   # TPU.ACTIVE_BATCH 4

        def argv(recipe, name, *extra):
            return ["-cfg", str(REPO / "configs" / recipe),
                    "TPU.DENSE_CONV_MODE", "pallas", "MODEL.WEIGHTS", "",
                    "resume", "", "SOLVER.NUM_ITER", str(steps),
                    "ACTIVE.SELECT_ITER", "[0]", "TPU.ACTIVE_BATCH", "4",
                    "TPU.VAL_INTERVAL", "0", "TPU.DATASET_DIR", str(data),
                    "OUTPUT_DIR", str(root / "out"), "NAME", name,
                    "SEED", str(args.seed), *extra]

        def run_train(label, recipe, name, *extra):
            mask_cache.clear()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            t0 = time.perf_counter()
            learner = train.main(argv(recipe, name, *extra), device=DEVICE,
                                 stage_seconds={})
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = counts()
            hist = learner.history
            if len(hist) != steps or not all(
                    math.isfinite(v) for rec in hist for k, v in rec.items()
                    if k.startswith(("loss", "negative", "consistency"))):
                raise AssertionError(f"{label}: {hist}")
            if learner.active_round != 2:
                raise AssertionError(f"{label}: rounds "
                                     f"{learner.active_round - 1}")
            step_ms = [(a + b) * 1e3 for a, b in learner.step_seconds]
            load_ms = [a * 1e3 for a, _ in learner.step_seconds]
            print(f"{label} ({learner.cfg.MODEL.NAME}, HYPER "
                  f"{learner.cfg.MODEL.HYPER}): ms/step median of steps "
                  f"2-{steps} {statistics.median(step_ms[1:]):.1f} (loader "
                  f"wait {statistics.median(load_ms[1:]):.1f}); each step "
                  f"{json.dumps([round(v, 1) for v in step_ms])}; peak "
                  f"device memory "
                  f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
                  f"run {wall:.1f} s (round 1 over {args.images} images "
                  f"included); {card}", flush=True)
            print(f"{label} losses: " + json.dumps(
                [{k: round(v, 5) for k, v in rec.items()
                  if k.startswith(("loss", "negative", "consistency"))}
                 for rec in hist]), flush=True)
            return learner, got

        def run_test(label, recipe, name, ckpt, want_embed, *extra):
            """The test entry with TEST.SAVE_EMBED over the 2 val images;
            returns the first batch's rich outputs and the counts."""
            make_rich = learners.make_rich_eval_step
            kept, call_ms = [], []

            def timed_rich(cfg, model):
                step = make_rich(cfg, model)

                def run(img, label, flip=True):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = step(img, label, flip=flip)
                    torch.cuda.synchronize()
                    call_ms.append((time.perf_counter() - t0) * 1e3)
                    if not kept:
                        kept.append(out)
                    return out

                return run

            learners.make_rich_eval_step = timed_rich
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            try:
                result = test_entry.main(
                    argv(recipe, name, "resume", ckpt, "TEST.SAVE_EMBED",
                         "True", *extra), device=DEVICE)
                torch.cuda.synchronize()
            finally:
                learners.make_rich_eval_step = make_rich
            got = counts()
            if len(call_ms) != 2 or not math.isfinite(result["mIoU"]):
                raise AssertionError(f"{label}: {result}, {len(call_ms)} "
                                     "batches")
            arts = sorted((root / "out" / name / "embed").glob("*.pt"))
            blob = torch.load(arts[0], weights_only=False)
            if len(arts) != 2 or ("embed" in blob) != want_embed:
                raise AssertionError(f"{label}: artifacts {arts}, keys "
                                     f"{sorted(blob)}")
            shapes = {k: tuple(v.shape) for k, v in blob.items()}
            print(f"{label}: mIoU {result['mIoU']:.4f} over 2 images; rich "
                  f"eval ms/img {json.dumps([round(v, 2) for v in call_ms])}"
                  f"; peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
                  f"artifacts {shapes}; {card}", flush=True)
            return kept[0], got

        def hold_radius(label, emb):
            """Kernel B on a rich eval's f32 embedding against its plain
            version, and on the same features scaled into the ball (the
            Euclidean decoder's features lie outside it, where the radius
            saturates); times kernel, plain version and the norm call."""
            inside = emb / (emb.norm(dim=-1, keepdim=True).max() * 1.05)
            rel, t_diff = 0.0, 0.0
            for x in (emb, inside.contiguous()):
                got = cuda_radius.radius_map(x)
                want = cuda_radius.radius_map_reference(x)
                torch.cuda.synchronize()
                t_diff = max(t_diff, float(
                    (torch.tanh(got / 2) - torch.tanh(want / 2)).abs().max()))
                inner = torch.tanh(want / 2) < 0.9
                if bool(inner.any()):
                    rel = max(rel, max_rel(torch, got[inner], want[inner]))
            if rel > 1e-6 or t_diff > 1e-6:
                raise AssertionError(f"{label}: kernel B off its plain "
                                     f"version: rel {rel}, |t| {t_diff}")
            inner = torch.tanh(cuda_radius.radius_map_reference(emb) / 2) \
                < 0.9
            ms = cuda_ms(torch, lambda i: cuda_radius.radius_map(emb), 64)
            plain = cuda_ms(
                torch, lambda i: cuda_radius.radius_map_reference(emb), 16)
            lib = cuda_ms(torch, lambda i: torch.linalg.vector_norm(
                emb, dim=-1), 64)
            n = emb.numel() // emb.shape[-1]
            b_ms, b_by = bound_ms(emb.numel() * 4 + n * 4, emb.numel() * 2)
            print(f"{label}: kernel B f32 on the {tuple(emb.shape)} "
                  f"embedding: {float(inner.float().mean()):.4f} of pixels "
                  f"at t < 0.9; with the scaled copy max rel diff "
                  f"{rel:.3e} (where t < 0.9), max |t| diff "
                  f"{t_diff:.3e}; kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                  f"vector_norm {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})"
                  f"; {card}", flush=True)

        # (e) RIPU with the pretrained trunk file.
        ripu, got = run_train("(e) ripu", "gtav/ripu.yaml", "ripu",
                              "MODEL.WEIGHTS", str(weights))
        n_conv = sum(isinstance(m, DilatedConv3x3)
                     for m in ripu.model.modules())
        if n_conv != 25:
            raise AssertionError(f"(e) {n_conv} kernel-C convs, want 25")
        expect("(e) ripu", got, {
            "fwd": n_conv * (2 * steps + batches), "dx": 2 * n_conv * steps,
            "radius_map": 0, "greedy_picks": batches})
        if "consistency_loss" not in ripu.history[0]:
            raise AssertionError("(e) ripu ran without LCR")
        # the trunk the round scored with is the file's
        before = load_state_dict_file(str(Path(ripu.cfg.SAVE_DIR)
                                          / "model_before_round_1.ckpt"))
        prefix = "feature_extractor.backbone."
        loaded = {k[len(prefix):]: v for k, v in before.items()
                  if k.startswith(prefix)
                  and not k.endswith("num_batches_tracked")}
        if not loaded or not all(torch.equal(v, trunk_file[k])
                                 for k, v in loaded.items()):
            raise AssertionError("(e) the trunk is not MODEL.WEIGHTS' file")
        print(f"(e) ripu: the trunk equals MODEL.WEIGHTS' file "
              f"({len(loaded)} tensors) before round 1", flush=True)
        ckpt = str(Path(ripu.cfg.SAVE_DIR) / "last.ckpt")
        del ripu, before, loaded, trunk_file
        release(torch)
        r, got = run_test("(e) ripu test", "gtav/ripu.yaml", "ripu_test",
                          ckpt, True)
        expect("(e) ripu test", got, {"fwd": 2 * n_conv, "dx": 0,
                                      "radius_map": 2, "greedy_picks": 0})
        if r["embed"].shape[-1] != 512:
            raise AssertionError(f"(e) decoder features {r['embed'].shape}")
        hold_radius("(e) ripu test", r["embed"])
        del r
        release(torch)

        # (f) DeepLab-v2, hyperbolic, on the headline recipe.
        v2, got = run_train("(f) deeplabv2 hyper", "gtav/source_target.yaml",
                            "deeplabv2", "MODEL.NAME", "deeplabv2_resnet101",
                            "MODEL.WEIGHTS", str(weights))
        w_in, h_in = v2.cfg.INPUT.INPUT_SIZE_TEST
        blocks = args.images * math.ceil(1024 / 128)  # 128-row blocks
        expect("(f) deeplabv2 hyper", got, {
            "fwd": n_conv * (2 * steps + batches), "dx": 2 * n_conv * steps,
            "radius_map": blocks, "greedy_picks": batches})
        ckpt = str(Path(v2.cfg.SAVE_DIR) / "last.ckpt")
        del v2
        release(torch)
        r, got = run_test("(f) deeplabv2 hyper test",
                          "gtav/source_target.yaml", "deeplabv2_test", ckpt,
                          True, "MODEL.NAME", "deeplabv2_resnet101")
        expect("(f) deeplabv2 hyper test", got, {
            "fwd": 2 * n_conv, "dx": 0, "radius_map": 2, "greedy_picks": 0})
        if tuple(r["embed"].shape) != (1, h_in // 8, w_in // 8, 64):
            raise AssertionError(f"(f) embedding {r['embed'].shape}")
        hold_radius("(f) deeplabv2 hyper test", r["embed"])
        del r
        release(torch)

        # (g) the random arm: no model, so no forward.
        cfg = get_default_cfg()
        cfg.set_new_allowed(True)
        cfg.merge_from_file(str(CONFIG))
        cfg.ACTIVE.UNCERTAINTY = "random"
        cfg.TPU.DATASET_DIR = str(data)
        cfg.TPU.ACTIVE_BATCH = 4
        cfg.SAVE_DIR = str(root / "out" / "random")
        cfg.SEED = args.seed
        mask_cache.clear()
        DatasetCatalog.init_mask(cfg)
        torch.cuda.reset_peak_memory_stats()
        stages = {}
        zero_counts()
        t0 = time.perf_counter()
        stats = region_selection(cfg, None, build_active_loader(cfg), 1,
                                 device=DEVICE, stage_seconds=stages)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counts()
        expect("(g) random arm", got, {"fwd": 0, "dx": 0, "radius_map": 0,
                                       "greedy_picks": batches})
        picks = math.ceil(1024 * 2048 * cfg.ACTIVE.BUDGET
                          / len(cfg.ACTIVE.SELECT_ITER) / 9)
        if stats["images"] != args.images or stats["picked"] != (
                args.images * picks):
            raise AssertionError(f"(g) random arm: {stats}")
        seed = random_arm_seed(cfg.SEED, 1, 0)
        on_card = prng.uniform(seed, (1024, 2048), device=DEVICE)
        on_cpu = prng.uniform(seed, (1024, 2048))
        if not torch.equal(on_card.cpu().view(torch.int32),
                           on_cpu.view(torch.int32)):
            raise AssertionError("(g) the card's random bits differ from "
                                 "the CPU's")
        bits_ms = cuda_ms(torch, lambda i: prng.uniform(
            seed, (1024, 2048), device=DEVICE), 10)
        print(f"(g) random arm: {stats}; {wall / args.images * 1e3:.1f} "
              f"ms/img wall; stages ms/img " + json.dumps(
                  {k: round(v / args.images * 1e3, 3)
                   for k, v in sorted(stages.items())})
              + f"; the card's score bits of image 0 equal the CPU's; one "
              f"1024x2048 score map {bits_ms:.3f} ms; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
              f"{card}", flush=True)
        del on_card, on_cpu
        release(torch)

        # (h) the other trunks, one forward and backward each.
        h, w = TRUNK_INPUT
        gen = torch.Generator(device=DEVICE).manual_seed(args.seed)
        for arch, remat, want_conv in TRUNKS:
            cfg = get_default_cfg()
            cfg.set_new_allowed(True)
            cfg.merge_from_file(str(CONFIG))
            cfg.MODEL.NAME = f"deeplabv3plus_{arch}"
            cfg.TPU.DENSE_CONV_MODE = "pallas"
            cfg.TPU.REMAT = remat
            label = f"(h) {arch}" + (" TPU.REMAT" if remat else "")
            model = build_segmentor(
                cfg, device=DEVICE,
                generator=torch.Generator().manual_seed(args.seed)).train()
            n_arch = sum(isinstance(m, DilatedConv3x3)
                         for m in model.modules())
            if n_arch != want_conv:
                raise AssertionError(f"{label}: {n_arch} kernel-C convs, "
                                     f"want {want_conv}")
            img = torch.randn((2, h, w, 3), generator=gen, device=DEVICE)
            target = torch.randint(0, 19, (2, h, w), generator=gen,
                                   device=DEVICE)
            forward = make_forward(model)

            def step():
                model.zero_grad(set_to_none=True)
                logits, _ = forward(img)
                loss = cross_entropy_loss(logits.float(), target)
                loss.backward()
                return loss

            step()   # first call: cuDNN plans, allocator
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            t0 = time.perf_counter()
            loss = step().detach()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            got = counts()
            # the recompute of a rematerialised block runs its convs again
            expect(label, got, {"fwd": n_arch * (2 if remat else 1),
                                "dx": n_arch, "radius_map": 0,
                                "greedy_picks": 0})
            grads = [p.grad for p in model.parameters() if p.requires_grad]
            if not (math.isfinite(float(loss)) and all(
                    g is not None and bool(torch.isfinite(g).all())
                    for g in grads)):
                raise AssertionError(f"{label}: loss {float(loss)} or a "
                                     "gradient not finite")
            print(f"{label}: forward + backward at 2x{h}x{w} "
                  f"{ms:.1f} ms, loss {float(loss):.4f}, {n_arch} kernel-C "
                  f"convs; peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
                  f"{card}", flush=True)
            del model, img, target, grads, loss
            release(torch)


def write_acdc(root: Path, seed: int, frames: int = 2, val: int = 2):
    """A synthetic ACDC tree at the set's native 1920x1080 (blocks of 8x8
    pixels): ``frames`` train frames in each of the four conditions, their
    basenames shared across the conditions (as ACDC's fog and night
    share them), and ``val`` val frames of distinct names; writes
    ``acdc_train_list.txt`` and ``acdc_val_list.txt``."""
    import numpy as np
    from PIL import Image
    from halo_tpu_torch.data.datasets import ID_TO_TRAINID_19

    rng = np.random.default_rng(seed)
    ids = np.array(list(ID_TO_TRAINID_19) + [0], np.uint8)
    h, w = ACDC_SIZE
    lists = {"train": [], "val": []}
    jobs = [("train", cond, "GOPR0000", f"GOPR0000_frame_{i:06d}")
            for cond in ("fog", "night", "rain", "snow")
            for i in range(frames)]
    jobs += [("val", ("fog", "night", "rain", "snow")[i % 4],
              f"GOPR01{i:02d}", f"GOPR01{i:02d}_frame_000000")
             for i in range(val)]
    for split, cond, seq, frame in jobs:
        img_p = (root / "acdc" / "rgb_anon" / cond / split / seq
                 / f"{frame}_rgb_anon.png")
        lab_p = (root / "acdc" / "gt" / cond / split / seq
                 / f"{frame}_gt_labelIds.png")
        img_p.parent.mkdir(parents=True, exist_ok=True)
        lab_p.parent.mkdir(parents=True, exist_ok=True)
        img = rng.integers(0, 256, (h // 8, w // 8, 3), np.uint8)
        lab = rng.choice(ids, (h // 8, w // 8))
        Image.fromarray(img.repeat(8, 0).repeat(8, 1)).save(img_p)
        Image.fromarray(lab.repeat(8, 0).repeat(8, 1)).save(lab_p)
        lists[split].append(f"{cond}/{seq}/{frame}_rgb_anon.png")
    for split, names in lists.items():
        (root / f"acdc_{split}_list.txt").write_text("\n".join(names) + "\n")


def write_mit_trunk(torch, path: Path, arch: str, seed: int):
    """A seeded NVlabs-layout MiT ``state_dict`` of ``arch`` (with the
    ImageNet ``head``) at ``path``: LeCun-scaled kernels, the residual
    branches' output projections (``attn.proj``, ``mlp.fc2``) scaled by
    0.1 so the residual stream stays bounded over the blocks, LayerNorm
    scales near 1 and small biases. Returns it."""
    from halo_tpu_torch.models.segformer import (MIT_ARCHS,
                                                 MixVisionTransformer)

    with torch.device("meta"):
        keys = MixVisionTransformer(**MIT_ARCHS[arch]).state_dict()
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in keys.items():
        shape = tuple(v.shape)
        if len(shape) >= 2:
            std = 1.0 / math.sqrt(math.prod(shape[1:]))
            if k.endswith(("attn.proj.weight", "mlp.fc2.weight")):
                std *= 0.1
            sd[k] = torch.randn(shape, generator=gen) * std
        elif "norm" in k and k.endswith("weight"):
            sd[k] = torch.rand(shape, generator=gen) * 0.2 + 0.9
        else:
            sd[k] = torch.randn(shape, generator=gen) * 0.02
    dims = MIT_ARCHS[arch]["embed_dims"]
    sd["head.weight"] = torch.zeros(1000, dims[-1])
    sd["head.bias"] = torch.zeros(1000)
    torch.save(sd, path)
    return sd


def profiled(torch, fn) -> tuple:
    """(device events, wall ms) of one call of ``fn`` under torch.profiler;
    no events when the trace fails (it is a report, not a check)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        return [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA], wall
    except Exception as exc:
        print(f"profiler: {type(exc).__name__}: {exc}", flush=True)
        return [], 0.0


def sdpa_kernels(torch, attn, x) -> str:
    """The device kernels one call of ``attn`` (an EfficientAttention)
    on ``x`` launches for its scaled_dot_product_attention."""
    with torch.no_grad(), torch.autocast(DEVICE, dtype=torch.bfloat16):
        attn(x)
        events, _ = profiled(torch, lambda: attn(x))
    names = sorted({e.key for e in events if any(
        s in e.key.lower() for s in ("flash", "fmha", "attention", "sdpa"))})
    return "; ".join(n[:100] for n in names) or "not measured"


def device_busy_ms(torch, fn) -> str:
    """The device time of the kernels and copies of one call of ``fn``
    beside its wall time, both under torch.profiler."""
    events, wall = profiled(torch, fn)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    if busy <= 0:
        return "not measured"
    return (f"{busy:.1f} ms of {wall:.1f} ms wall under the profiler (idle "
            f"share {1 - busy / wall:.3f})")


def phase_acdc(torch, args, report):
    """The Cityscapes -> ACDC recipes at full width (SegFormer-B4,
    hyperbolic head, 64 reduced channels, no HFR, 1280x640 inputs): round
    1, 3 steps and validation through train.main; the test entry; one
    forward and backward with and without TPU.REMAT. Launch counters are
    zeroed before each run and read at once after it."""
    import statistics

    from halo_tpu_torch import test as test_entry
    from halo_tpu_torch import train
    from halo_tpu_torch.active import cuda_radius, cuda_select
    from halo_tpu_torch.active.scoring import fused_upsample_region_score
    from halo_tpu_torch.config import get_default_cfg
    from halo_tpu_torch.data import mask_cache
    from halo_tpu_torch.data.build import build_active_loader
    from halo_tpu_torch.data.masks import load_indicator, load_mask_png
    from halo_tpu_torch.engine import learners, make_forward
    from halo_tpu_torch.engine.state import load_state_dict_file
    from halo_tpu_torch.losses import cross_entropy_loss
    from halo_tpu_torch.models import build_segmentor
    from halo_tpu_torch.ops import dilated_conv as dc
    from halo_tpu_torch.ops.resize import resize_bilinear

    card = card_line()
    steps = 3
    recipe = REPO / "configs" / "acdc" / "source_target.yaml"

    def counts():
        return {"fwd": dc.launches_fwd, "dx": dc.launches_dx,
                "radius_map": cuda_radius.launches,
                "greedy_picks": cuda_select.launches}

    def zero_counts():
        dc.launches_fwd = dc.launches_dx = dc.layout_copies = 0
        cuda_radius.launches = cuda_select.launches = 0

    def expect(label, got, want):
        if got != want:
            raise AssertionError(f"{label}: launches {got}, want {want}")
        print(f"{label}: launches {got}", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        data = root / "datasets"
        t0 = time.perf_counter()
        write_cityscapes(data, args.images, args.seed)
        write_acdc(data, args.seed)
        weights = root / "mit_b4.pth"
        trunk_file = write_mit_trunk(torch, weights, "mitb4", args.seed)
        print(f"acdc setup (synthetic Cityscapes source and ACDC trees, "
              f"NVlabs-layout MiT-B4 file): {time.perf_counter() - t0:.1f} s",
              flush=True)
        h_nat, w_nat = ACDC_SIZE

        def argv(path, name, *extra):
            return ["-cfg", str(path), "MODEL.WEIGHTS", str(weights),
                    "resume", "", "SOLVER.NUM_ITER", str(steps),
                    "TPU.ACTIVE_BATCH", "4", "TPU.DATASET_DIR", str(data),
                    "OUTPUT_DIR", str(root / "out"), "NAME", name,
                    "SEED", str(args.seed), *extra]

        # (1) train.main: round 1 at step 0, 3 steps, validation.
        rounds = []
        round_fn = learners.region_selection

        def kept_round(*a, **k):
            stats = round_fn(*a, **k)
            rounds.append(stats)
            return stats

        learners.region_selection = kept_round
        mask_cache.clear()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        stages = {}
        t0 = time.perf_counter()
        try:
            learner = train.main(argv(recipe, "acdc", "TPU.VAL_INTERVAL",
                                      str(steps)),
                                 device=DEVICE, stage_seconds=stages)
            torch.cuda.synchronize()
        finally:
            learners.region_selection = round_fn
        wall = time.perf_counter() - t0
        got = counts()
        cfg = learner.cfg
        entries = learner.active_loader.dataset.data_list
        n_img = len(entries)
        batches = math.ceil(n_img / 4)
        blocks = math.ceil(h_nat / 128)   # kernel B's 128-row blocks
        expect("acdc train", got, {"fwd": 0, "dx": 0,
                                   "radius_map": n_img * blocks,
                                   "greedy_picks": batches})
        picks = math.ceil(h_nat * w_nat * cfg.ACTIVE.BUDGET
                          / len(cfg.ACTIVE.SELECT_ITER) / 9)
        if (len(rounds) != 1 or rounds[0]["images"] != n_img
                or rounds[0]["picked"] != n_img * picks):
            raise AssertionError(f"acdc round 1: {rounds}, want {n_img} "
                                 f"images x {picks} picks")
        stems = set()
        for entry in entries:
            mask = load_mask_png(entry["label_mask"])
            ind = load_indicator(entry["indicator"])
            if (mask.shape != (h_nat, w_nat)
                    or ind["selected"].shape != (h_nat, w_nat)
                    or (ind["selected"] & ~ind["active"]).any()
                    or ((mask != 255) & ~ind["selected"]).any()
                    or not (mask != 255).any()):
                raise AssertionError(f"acdc round 1: bad mask/indicator "
                                     f"for {entry['name']}")
            stems.add(Path(entry["label_mask"]).relative_to(
                Path(cfg.SAVE_DIR) / "gtMask" / "train").parts[0])
        if stems != {"fog", "night", "rain", "snow"}:
            raise AssertionError(f"acdc masks not under the conditions: "
                                 f"{stems}")
        hist = learner.history
        if len(hist) != steps or not all(
                math.isfinite(v) for rec in hist for k, v in rec.items()
                if k.startswith(("loss", "negative"))):
            raise AssertionError(f"acdc steps: {hist}")
        # Every parameter was updated (a finite, nonzero momentum
        # buffer); at the warmup LR (1e-5) the updates of LayerNorm scales
        # near 1 can stay below float32's rounding, so not all values move.
        before = load_state_dict_file(str(Path(cfg.SAVE_DIR)
                                          / "model_before_round_1.ckpt"))
        after = learner.model.state_dict()
        params = [(n, p) for n, p in learner.model.named_parameters()
                  if p.requires_grad]
        state = learner.optimizer.state
        idle = [n for n, p in params
                if "momentum_buffer" not in state[p]
                or not bool(torch.isfinite(state[p]["momentum_buffer"]).all())
                or not bool(state[p]["momentum_buffer"].any())]
        still = [n for n, p in params
                 if torch.equal(before[n], after[n].cpu())]
        n_params = len(params)
        prefix = "feature_extractor.backbone."
        loaded = {k[len(prefix):]: v for k, v in before.items()
                  if k.startswith(prefix)}
        if idle or loaded.keys() != trunk_file.keys() - {
                "head.weight", "head.bias"} or not all(
                torch.equal(v, trunk_file[k]) for k, v in loaded.items()):
            raise AssertionError(f"acdc: parameters without an update "
                                 f"{idle[:5]}, or the trunk is not "
                                 "MODEL.WEIGHTS' file")
        if not (math.isfinite(learner.best_miou) and learner.best_miou >= 0):
            raise AssertionError(f"acdc validation mIoU {learner.best_miou}")
        step_ms = [(a + b) * 1e3 for a, b in learner.step_seconds]
        load_ms = [a * 1e3 for a, _ in learner.step_seconds]
        print(f"acdc train ({cfg.MODEL.NAME}, HYPER {cfg.MODEL.HYPER}, HFR "
              f"{cfg.MODEL.HFR}): round 1 {rounds[0]}, {picks} picks an "
              f"image, masks under {sorted(stems)}; ms/step median of steps "
              f"2-{steps} {statistics.median(step_ms[1:]):.1f} (loader wait "
              f"{statistics.median(load_ms[1:]):.1f}); each step "
              f"{json.dumps([round(v, 1) for v in step_ms])}; stages s "
              + json.dumps({k: round(v, 3) for k, v in stages.items()})
              + f"; all {n_params} parameters updated, "
              f"{n_params - len(still)} of them moved (unmoved: "
              f"{sorted({n.rsplit('.', 2)[-2] for n in still})}); the "
              f"trunk was the file's ({len(loaded)} tensors); validation "
              f"mIoU "
              f"{learner.best_miou:.4f} over 2 images; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; run "
              f"{wall:.1f} s; {card}", flush=True)
        print("acdc losses: " + json.dumps(
            [{k: round(v, 5) for k, v in rec.items()
              if k.startswith(("loss", "negative"))} for rec in hist]),
            flush=True)

        # Kernels A and B on the first image's real maps.
        loader = build_active_loader(cfg, num_workers=0)
        batch = next(iter(loader))
        model = learner.model.eval()
        forward = make_forward(model)
        with torch.no_grad():
            logits, embed = forward(torch.as_tensor(batch["img"],
                                                    device=DEVICE))
            if not (bool(torch.isfinite(logits).all())
                    and bool((embed.norm(dim=-1) < 1).all())):
                raise AssertionError("acdc forward not finite / in ball")
            score, _, _ = fused_upsample_region_score(
                logits[0], embed[0], (h_nat, w_nat),
                score_dtype=torch.bfloat16)
            kw = dict(num_picks=picks, mask_radius=cfg.ACTIVE.MASK_RADIUS_K)
            a_got = cuda_select.greedy_picks(score, **kw)
            t0 = time.perf_counter()
            a_want = cuda_select.greedy_picks_reference(score, **kw)
            torch.cuda.synchronize()
            a_plain = (time.perf_counter() - t0) * 1e3
            native = resize_bilinear(embed[0].float(), (h_nat, w_nat))
            native = native.to(torch.bfloat16)
        same_picks(torch, a_got, a_want, "real ACDC score map")
        a_ms = cuda_ms(torch, lambda i: cuda_select.greedy_picks(score, **kw),
                       5, warmup=1)
        maps = score.expand(4, -1, -1).contiguous()
        a4_ms = cuda_ms(torch, lambda i: cuda_select.greedy_picks(maps, **kw),
                        5, warmup=1)
        a_bound, a_by = bound_ms(
            h_nat * w_nat * 4 + picks * 2 * 4 + 4,
            h_nat * w_nat + picks * (2 * kw["mask_radius"] + 1) * h_nat)
        rel, t_diff, share = 0.0, 0.0, []
        b_rows = {}
        for r0 in range(0, h_nat, 128):
            blk = native[r0:r0 + 128].contiguous()
            got_b = cuda_radius.radius_map(blk)
            want_b = cuda_radius.radius_map_reference(blk)
            torch.cuda.synchronize()
            t_diff = max(t_diff, float((torch.tanh(got_b / 2) - torch.tanh(
                want_b / 2)).abs().max()))
            inner = torch.tanh(want_b / 2) < 0.9
            share.append(float(inner.float().mean()))
            if bool(inner.any()):
                rel = max(rel, max_rel(torch, got_b[inner], want_b[inner]))
            b_rows[blk.shape[0]] = blk
        if rel > 1e-6 or t_diff > 1e-6:
            raise AssertionError(f"acdc kernel B off its plain version on "
                                 f"the real embedding: rel {rel}, |t| "
                                 f"{t_diff}")
        timing = []
        for rows, blk in sorted(b_rows.items()):
            n = rows * w_nat
            ms = cuda_ms(torch, lambda i: cuda_radius.radius_map(blk), 64)
            plain = cuda_ms(torch, lambda i: cuda_radius.radius_map_reference(
                blk), 16)
            lib = cuda_ms(torch, lambda i: torch.linalg.vector_norm(
                blk, dim=-1, dtype=torch.float32), 64)
            b_ms, b_by = bound_ms(n * 64 * 2 + n * 4, n * 64 * 2)
            timing.append(f"({rows}, {w_nat}, 64) bf16: kernel {ms:.4f} ms, "
                          f"plain {plain:.4f} ms, vector_norm {lib:.4f} ms, "
                          f"bound {b_ms:.4f} ms ({b_by})")
        print(f"acdc kernel A on the first image's real {h_nat}x{w_nat} "
              f"score map: bit-exact with its plain version, {picks} picks "
              f"(m = {kw['mask_radius']}) {a_ms:.3f} ms "
              f"({a_ms / picks * 1e3:.3f} us/pick), 4 maps in one launch "
              f"{a4_ms:.3f} ms, plain {a_plain:.1f} ms, bound {a_bound:.4f} "
              f"ms ({a_by}); kernel B on its {len(share)} native 128-row "
              f"blocks (the last {h_nat - 128 * (len(share) - 1)} rows): "
              f"{statistics.mean(share):.4f} of pixels at t < 0.9, max rel "
              f"diff {rel:.3e}, max |t| diff {t_diff:.3e}; "
              + "; ".join(timing) + f"; {card}", flush=True)
        print("acdc SDPA kernels at stage 1 (2, 160, 320, 64) bf16: "
              + sdpa_kernels(torch, model.feature_extractor.backbone
                             .block1[0].attn,
                             torch.randn((2, 160, 320, 64), device=DEVICE)),
              flush=True)
        ckpt = str(Path(cfg.SAVE_DIR) / "last.ckpt")
        del learner, model, before, after, loaded, trunk_file, score, maps
        del native, b_rows, logits, embed
        release(torch)

        # (2) The test entry on acdc_val.
        make_rich = learners.make_rich_eval_step
        kept, call_ms = [], []

        def timed_rich(cfg, model):
            step = make_rich(cfg, model)

            def run(img, label, flip=True):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(img, label, flip=flip)
                torch.cuda.synchronize()
                call_ms.append((time.perf_counter() - t0) * 1e3)
                if not kept:
                    kept.append(out)
                return out

            return run

        learners.make_rich_eval_step = timed_rich
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        try:
            result = test_entry.main(
                argv(REPO / "configs" / "acdc" / "test.yaml", "acdc_test",
                     "resume", ckpt, "TEST.SAVE_EMBED", "True"),
                device=DEVICE)
            torch.cuda.synchronize()
        finally:
            learners.make_rich_eval_step = make_rich
        wall = time.perf_counter() - t0
        got = counts()
        n_val = len(call_ms)
        expect("acdc test", got, {"fwd": 0, "dx": 0, "radius_map": n_val,
                                  "greedy_picks": 0})
        if n_val != 2 or not math.isfinite(result["mIoU"]):
            raise AssertionError(f"acdc test: {result}, {n_val} batches")
        arts = sorted((root / "out" / "acdc_test" / "embed").glob("*.pt"))
        w_in, h_in = cfg.INPUT.INPUT_SIZE_TEST
        want = {"label": ("int32", (1, h_nat, w_nat)),
                "pred": ("int32", (1, h_nat, w_nat)),
                "output": ("float32", (1, h_nat, w_nat, 19)),
                "embed": ("float32", (1, h_in // 4, w_in // 4, 64))}
        for path in arts:
            blob = torch.load(path, weights_only=False)
            shapes = {k: (str(v.dtype).split(".")[-1], tuple(v.shape))
                      for k, v in blob.items()}
            if shapes != want:
                raise AssertionError(f"acdc test {path.name}: {shapes}")
        if len(arts) != 2:
            raise AssertionError(f"acdc test artifacts {arts}")
        r = kept[0]
        size = tuple(r["radius"].shape[1:3])
        plain = resize_bilinear(cuda_radius.radius_map_reference(
            r["embed"])[..., None], size)[..., 0]
        t_diff = float((torch.tanh(r["radius"] / 2)
                        - torch.tanh(plain / 2)).abs().max())
        inner = torch.tanh(plain / 2) < 0.9
        rel = (max_rel(torch, r["radius"][inner], plain[inner])
               if bool(inner.any()) else 0.0)
        if rel > 1e-6 or t_diff > 1e-6:
            raise AssertionError(f"acdc test: rich radius off the plain "
                                 f"dist0: rel {rel}, |t| diff {t_diff}")
        emb = r["embed"]
        ms = cuda_ms(torch, lambda i: cuda_radius.radius_map(emb), 64)
        plain_ms = cuda_ms(
            torch, lambda i: cuda_radius.radius_map_reference(emb), 16)
        lib = cuda_ms(torch, lambda i: torch.linalg.vector_norm(
            emb, dim=-1), 64)
        n = emb.numel() // emb.shape[-1]
        b_ms, b_by = bound_ms(emb.numel() * 4 + n * 4, emb.numel() * 2)
        print(f"acdc test: mIoU {result['mIoU']:.4f} over {n_val} images; "
              f"rich eval ms/img {json.dumps([round(v, 2) for v in call_ms])}"
              f" (entry {wall:.1f} s with model build and resume); peak "
              f"device memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
              f"artifacts {[p.name for p in arts]} with the JAX keys, "
              f"dtypes and shapes; rich radius vs plain dist0: "
              f"{float(inner.float().mean()):.4f} of pixels at t < 0.9 (max "
              f"rel diff {rel:.3e}), max |t| diff {t_diff:.3e}; kernel B f32 "
              f"on the {tuple(emb.shape)} embedding {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, vector_norm {lib:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}); {card}", flush=True)
        del kept, r, emb, plain
        release(torch)

    # (3) One forward and backward of segformer_mitb4 at 2x640x1280.
    h, w = TRUNK_INPUT
    gen = torch.Generator(device=DEVICE).manual_seed(args.seed)
    for remat in (False, True):
        cfg = get_default_cfg()
        cfg.set_new_allowed(True)
        cfg.merge_from_file(str(recipe))
        cfg.TPU.REMAT = remat
        label = "acdc segformer_mitb4" + (" TPU.REMAT" if remat else "")
        model = build_segmentor(
            cfg, device=DEVICE,
            generator=torch.Generator().manual_seed(args.seed)).train()
        img = torch.randn((2, h, w, 3), generator=gen, device=DEVICE)
        target = torch.randint(0, 19, (2, h, w), generator=gen,
                               device=DEVICE)
        forward = make_forward(model)

        def step():
            model.zero_grad(set_to_none=True)
            logits, _ = forward(img)
            loss = cross_entropy_loss(logits.float(), target)
            loss.backward()
            return loss

        step()   # first call: cuDNN plans, allocator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            loss = step().detach()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(times)
        expect(label, counts(), {"fwd": 0, "dx": 0, "radius_map": 0,
                                 "greedy_picks": 0})
        busy = device_busy_ms(torch, step)
        grads = [p.grad for p in model.parameters() if p.requires_grad]
        if not (math.isfinite(float(loss)) and all(
                g is not None and bool(torch.isfinite(g).all())
                for g in grads)):
            raise AssertionError(f"{label}: loss {float(loss)} or a "
                                 "gradient not finite")
        print(f"{label}: forward + backward at 2x{h}x{w} median {ms:.1f} "
              f"ms of {json.dumps([round(v, 1) for v in times])}, loss "
              f"{float(loss):.4f}; device busy in one profiled step "
              f"{busy}; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
              f"{card}", flush=True)
        del model, img, target, grads, loss
        release(torch)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--images", type=int, default=8)
    parser.add_argument("--profile", metavar="TRACE.json",
                        help="trace the round, and 3 train steps in each "
                        "conv mode, with torch.profiler; write the chrome "
                        "traces here (and beside it) and print the device "
                        "busy share and the top kernels")
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
    phase_conv(torch, gen, report)
    phase_slice(torch, args, report)
    phase_train(torch, args, report)
    phase_protocols(torch, args, report)
    phase_families(torch, args, report)
    phase_acdc(torch, args, report)
    print(json.dumps({"kernels": [report["greedy_picks"],
                                  report["radius_map"],
                                  report["dilated_conv3x3"]]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
