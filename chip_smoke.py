#!/usr/bin/env python3
"""Smoke test of the PyTorch port (halo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--images N] [--profile TRACE.json]

Phases, each of which fails the run (non-zero exit) on any error:

  1. build   compile halo_tpu_torch/csrc/*.cu for sm_90a (one nvcc per
             source, in parallel) into build/cuda/.
  2. radius  kernel B against its plain version (dist0 in float32) on a
             (128, 2048, 64) bf16 block, a full 1024x2048x64 map and the
             rich eval's f32 (1, 160, 320, 64) embedding, within 1e-6
             relative; times kernel, plain version and
             torch.linalg.vector_norm at the rich eval's shape (the
             kernels line's), and the kernel on the block and the map.
  3. score   the score kernel pair (S1 + S2, csrc/region_score.cu: kernel B
             redesigned as the round's score stage) against its plain
             version (cuda_score.region_score_plain) at 1024x2048 from
             640x1280x19 logits and a 160x320x64 embedding, ACDC's
             1080x1920 and a ragged shape, bf16 and float32 score dtype:
             the entropy within 2e-6 relative to the larger of itself and
             log(sum e^v) / log 19, the operand it is cancelled from, and
             the radius in tanh(r/2) within 1e-6 (the raw maps), score,
             impurity and uncertainty within 1e-5; prints the share of kernel A's picks the two
             score maps share; times the pair, the plain version and a
             yardstick composite of PyTorch calls beside the bound;
             counts the device kernels of the round's call.
  4. select  kernel A against its plain version (the column-cache loop),
             bit-exact, on a 1024x2048 map with 2331 picks, m = 5, a
             pre-active block and a tie plateau, an early-stop case, and
             a batch of 4 maps in one launch (one stops early); times
             one map, the batch (us a pick) and the plain version.
  5. conv    kernel C (the dilated 3x3 conv) against its plain version,
             forward, dx and dk through autograd, at the train step's
             shapes (B = 2, the source's 90x160: 256 ch d=2, 512 ch d=2,
             512 ch d=4, bf16, 256 ch d=2 float32; the target's 80x160:
             256 ch d=2, 512 ch d=4, bf16), after one small forward and one
             small dk launch synchronised at once: bf16 within one bf16
             step beyond 1e-5 of max|out| (dk: of wgrad_taps on float32
             operands; two dk calls bit-identical), f32 within 1e-5 of
             max|out|; times kernel (fwd, dx and, in bf16, the weight-
             gradient kernel), plain version, F.conv2d (cuDNN), its dgrad
             and wgrad, and wgrad_taps (the plain dk, the f32 path's dk),
             with the bound of each; for the bf16 dk also its share of the
             bound, the profiler's time of each of its kernels, and its
             plan (ops/dilated_conv.wgrad_plan) with the L2 bytes it
             reckons.
  6. slice   the acquisition round of configs/gtav/source_target.yaml
             (DeepLab-v3+ R101, hyperbolic head with HFR, 640x1280 input,
             entropy x radius, 1% a round) from a seeded random init over a
             synthetic 1024x2048 Cityscapes tree: 2331 picks an image,
             every mask PNG and indicator written, the kernels launched
             on the path (launch counters: S1 and S2 once an image, kernel
             B never, kernel A once a batch), ms/img by stage; then on the
             first image's real outputs S1's raw maps against the plain
             version (uncertainty within 1e-5 of its largest value,
             radius within 1e-6 in tanh(r/2)) and S2's maps against torch's
             normalisation of them (1e-6), kernel A held bit-exact (and
             timed) on its score map and kernel B within 1e-6 on its
             embedding's first native block.
  7. train   halo_tpu_torch.train.main on the same recipe with
             TPU.DENSE_CONV_MODE pallas (source 2x720x1280, target
             2x640x1280) over synthetic GTAV (1914x1052) and Cityscapes
             trees: round 1 at step 0, 8 train steps, validation on
             2 images, checkpoints. Checks masks, finite losses, moved
             parameters and unchanged FrozenBN buffers, kernel C's
             launches (50 forward + 50 dx + 50 dk a step), A's and the
             score pair's (B none), the mIoU, last.ckpt loading with strict=True, and kernel
             C (fwd, dx, dk) on the first step's real layer3/layer4
             activations and cotangents; prints ms/step (median of steps
             3-8), stages and peak memory, then ms/step with
             TPU.DENSE_CONV_MODE conv; in each mode the median of 5 steps
             on one device-resident batch between CUDA events (no loader).
             --profile adds kernel C's wrapper split by function.
  8. protocols  the pipeline on the same model width with
             TPU.DENSE_CONV_MODE pallas over synthetic SYNTHIA (1280x760,
             16-bit labels) and Cityscapes trees: (a) SYNTHIA source
             pretraining, 3 steps, 16 classes (kernel C's dk launches as
             many as its dx in every run); (b) source_free resumed
             from (a)'s last.ckpt, round 1 at step 0, 3 steps; (c)
             halo_tpu_torch.test.main on (b)'s last.ckpt with
             TEST.SAVE_EMBED over 2 val images: mIoU*, the embed/*.pt
             artifacts, one kernel-B launch a rich-eval batch, kernel C in
             the eval forwards, and the first image's rich radius map
             against the plain dist0 of its embedding; (d) GTAV fully_sup,
             3 steps, no round. Kernel launches are counted around each
             run; each run prints ms/step (or ms/img), loader wait and
             peak memory.
  9. families  the other DeepLab models and the control arm, full width,
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
 10. acdc    the Cityscapes -> ACDC recipes at full width (segformer_mitb4,
             hyperbolic head, 64 reduced channels, no HFR, 1280x640
             inputs), over a synthetic Cityscapes source tree and an ACDC
             tree at 1920x1080 (fog, night, rain, snow; 2 train frames each
             with shared basenames, 2 val frames), MODEL.WEIGHTS an
             NVlabs-layout MiT-B4 .pth written from --seed: (1)
             train.main on configs/acdc/source_target.yaml, round 1 at
             step 0 (2304 picks an image, masks and indicators under the
             nested stems; launches A 2, S1 + S2 one an image, C 0), 3 steps,
             validation on 2 images; the score kernels held on the first
             image's real outputs as in phase slice, kernel A bit-exact
             (and timed) and
             kernel B within 1e-6 on each 128-row block of the first
             image's real 1080x1920 maps, the ragged 56-row block
             included; the SDPA kernels the attention runs; (2)
             halo_tpu_torch.test.main on configs/acdc/test.yaml with the
             run's last.ckpt and TEST.SAVE_EMBED (one kernel-B f32 launch
             a batch, held against the plain dist0); (3) forward and
             backward of segformer_mitb4 at 2x640x1280, with and without
             TPU.REMAT: the median of 3 steps, and the device's busy time
             in a fourth under torch.profiler.
 11. int8    int8 (W8A8) evaluation and the int8 sweep, every quantised
             layer kernel Q (the activation quantise, csrc/int8_quant.cu)
             then kernel I (the int8 conv, csrc/int8_conv.cu): (1) Q and I
             bit for bit against their plain versions (float64 sums of the
             int8 values) at the path's shapes (R101 at a 640x1280 input:
             layer1 3x3 64, layer2's 3x3 128 stride 2 and d=1, layer3 256
             d=2, layer4 512 d=4, the ASPP bottleneck 2560->512; MiT-B4's
             pe3 3x3 stride 2 128->320) at B = 2 (the test entry's flip
             pair) and 4 (the sweep), bf16 and f32 out, at the one-tap
             GEMMs of the 1x1 convs and dense layers (M = 2 included), on
             the ASPP bottleneck's concatenated input (not channels-last)
             and at edge cases (odd H and W, channels no multiple of the
             tile or of 16, a padded 1x1, 5x5, 4x4 stride 4, amax below
             max|x| and 0); times I beside its bound, its plain version and
             cuDNN's bf16 conv (k x k) or torch._int_mm + dequant (GEMMs),
             and Q beside its bound; (2) halo_tpu_torch.test.main on
             configs/gtav/test.yaml with TPU.QUANT_EVAL True and
             TEST.SAVE_EMBED on phase train's last.ckpt over 2 val images,
             calibrated on the target train split: Q and I launches 2 a
             quantised layer as the eligibility rule counts them,
             torch._int_mm 0, layout copies 0, kernel C 0, kernel B 1 a
             batch, the rich radius map against the plain dist0, then the
             float entry on the same checkpoint (mIoU, ms/img and the
             share of pixels predicted alike); (3) the same on
             configs/acdc/test.yaml with phase acdc's last.ckpt
             (segformer_mitb4); (4) train.main on
             configs/gtav/source_target.yaml with TPU.QUANT_SWEEP True and
             TPU.DENSE_CONV_MODE pallas, round 1 at step 0 and 2 steps:
             2331 picks an image from the int8 twin, masks and indicators,
             launches (A 2, S1 + S2 8, Q and I in the sweep, C in the steps),
             every twin amax > 0, the round's stages, then a float round
             on the same weights (stages and the share of its labelled
             pixels the int8 round labelled). Every earlier phase runs at
             its full depth.
 12. parallel  data parallelism over torch.distributed at the recipe's
             full width (configs/gtav/source_target.yaml, TPU.DENSE_CONV_MODE
             pallas, the synthetic GTAV and Cityscapes trees of phase
             train, round 1 at step 0 over the 8 images, 3 steps,
             validation on 2), each run a process of its own (this script
             with --parallel-child), joined with a timeout: (a) one rank
             over NCCL (RANK 0, WORLD_SIZE 1) beside the same run with no
             group: masks and indicators byte-identical, losses within
             1e-5 relative, launches equal (A 2, S1 + S2 8, C 250 + 150 + 150),
             ms/step of each on one device-resident batch between CUDA
             events; (b) two ranks sharing the card over gloo
             (device cuda:0, SOLVER.BATCH_SIZE 2 each): each scores 4
             images (A 1, S1 + S2 4), masks byte-identical with (a)'s,
             bit-identical parameters after 3 steps, one mIoU, checkpoints
             and metrics.jsonl by rank 0 alone, last.ckpt loading with
             strict=True into a model built in one process, ms/step of
             each rank; (c) spatial_region_score over (b)'s two ranks on a
             1024x2048 map (19 classes, a 64-wide embedding, 512 rows and
             one kernel-B launch a rank) against floating_region_score of
             the whole map within 1e-6, for both purity pairs. The phase's
             launches join the kernels line.
 13. quality  the user tools (halo_tpu_torch/tools/), after kernels A,
             B and C are held against their plain versions at the shapes
             the tools give them (C fwd, dx, dk at resnettiny's layer4
             conv2, 2 and 4 x 512 x 12 x 16 bf16, d = 2; B on 96x128x16
             bf16 and float32 and 256x512x64 float32 maps; A bit-exact on
             a stack of four 96x128 maps, 28 picks, m = 5, and a 256x512
             map, 100 picks): (a) the
             acquisition-quality A/B at the JAX harness's recipe (seed 0,
             400-step source pretrain of deeplabv3plus_resnettiny at
             128x96, then halo, random and none arms of 48 steps at a
             budget of 0.04 a round; bf16, TPU.DENSE_CONV_MODE pallas, so
             kernel C in the dilated convs, B and A in the rounds):
             finite losses, halo's budget on the shifted classes at 2x
             their base rate and 2x random's, both annotated arms above
             none (halo against random is printed, not asserted); (b) the
             radius-rarity probe on (a)'s pretrain checkpoint: a finite
             mean radius in (0, 2 artanh(1 - 1e-7)] for every present
             class, top-4% shares summing to 1; (c) the mIoU-parity
             command on configs/gtav/test.yaml (R101, hyperbolic, HFR,
             TPU.DENSE_CONV_MODE pallas) with a seeded reference-format
             Lightning checkpoint over 2 synthetic 1024x2048 val images:
             exit 2 at --budget 5, then 0 at --expected-miou the measured
             value, the same mIoU; (d) the quickstart at its defaults (R101,
             256x512): 100 regions. Each part's seconds and launches are
             printed; the phase's launches join the kernels line.

Prints each phase's seconds, the kernels JSON line, the card's name and
power limit
(nvidia-smi), and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Needs a CUDA device and the repository around it; exits non-zero without.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import re
import shutil
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


def kernel_ms(torch, fn, names, iters: int = 10) -> dict:
    """Device ms a call of each kernel whose name holds one of ``names``,
    from torch.profiler over ``iters`` calls of fn (kernel time alone),
    keyed by the kernel's own name (the identifier that holds the match)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        for name in names:
            hit = re.search(r"\w*" + name + r"\w*", e.key)
            if hit:
                out[hit.group()] = out.get(hit.group(), 0.0) + \
                    e.self_device_time_total / 1e3 / iters
                break
    return out


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


def ball_points(torch, shape, gen, dtype=None):
    """Points of the Poincare ball (bf16 unless ``dtype`` says): random
    directions, radii uniform in [0, 0.95)."""
    x = torch.randn(shape, generator=gen, device=DEVICE)
    r = torch.rand(shape[:-1] + (1,), generator=gen, device=DEVICE) * 0.95
    return (x / x.norm(dim=-1, keepdim=True) * r).to(dtype or torch.bfloat16)


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
    # the rich eval's map (a 640x1280 input's f32 (1, 160, 320, 64)
    # embedding), which is what the main path gives kernel B since the
    # round's score stage went to the score kernel pair; eight of them
    # (105 MB > L2) in turn so each launch reads from device memory
    rich = [ball_points(torch, (1, 160, 320, 64), gen, dtype=torch.float32)
            for _ in range(8)]
    got = cuda_radius.radius_map(rich[0])
    want = cuda_radius.radius_map_reference(rich[0])
    torch.cuda.synchronize()
    rel = max_rel(torch, got, want)
    worst = max(worst, rel)
    worst_abs = max(worst_abs, float((got - want).abs().max()))
    print(f"radius rich eval (1, 160, 320, 64) f32: max rel diff {rel:.3e}",
          flush=True)
    if worst > 1e-6:
        raise AssertionError(f"kernel B off its plain version: {worst}")
    n_r = 160 * 320
    ms = cuda_ms(torch, lambda i: cuda_radius.radius_map(rich[i % 8]), 64)
    plain = cuda_ms(torch, lambda i: cuda_radius.radius_map_reference(
        rich[i % 8]), 16)
    lib = cuda_ms(torch, lambda i: torch.linalg.vector_norm(
        rich[i % 8], dim=-1, dtype=torch.float32), 64)
    b_ms, b_by = bound_ms(n_r * 64 * 4 + n_r * 4, n_r * 64 * 2)
    print(f"radius rich eval (1, 160, 320, 64) f32: kernel {ms:.4f} ms, "
          f"plain {plain:.4f} ms, vector_norm {lib:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by})", flush=True)
    # the 128-row bf16 block the round gave B before the score kernel pair
    # (printed only: no path launches B at this shape now)
    blocks = [full[i * 128:(i + 1) * 128] for i in range(8)]
    blk_ms = cuda_ms(torch, lambda i: cuda_radius.radius_map(blocks[i % 8]),
                     64)
    ms_full = cuda_ms(torch, lambda i: cuda_radius.radius_map(full), 16)
    n = 128 * 2048
    b_blk, _ = bound_ms(n * 64 * 2 + n * 4, n * 64 * 2)
    b_full, _ = bound_ms(8 * (n * 64 * 2 + n * 4), 8 * n * 64 * 2)
    print(f"radius 128x2048x64 bf16 block: kernel {blk_ms:.4f} ms, bound "
          f"{b_blk:.4f} ms; full 1024x2048x64: kernel {ms_full:.4f} ms, "
          f"bound {b_full:.4f} ms", flush=True)
    report["radius_map"] = {
        "name": "radius_map", "route": "cuda",
        "source": "halo_tpu_torch/csrc/radius.cu",
        "replaces": "halo_tpu/active/pallas_radius.py:100",
        "launches": 0, "max_abs_err": worst_abs, "ms": ms, "plain_ms": plain,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}


# phase score: (label, native (H, W), logits (h, w), embedding (h2, w2),
# picks an image at 1% and m = 5 as the round makes them)
SCORE_CASES = (("cityscapes", (1024, 2048), (640, 1280), (160, 320), 2331),
               ("acdc", (1080, 1920), (640, 1280), (160, 320), 2304),
               ("ragged", (1000, 1900), (637, 1277), (157, 311), 2112))
SCORE_IMAGES = 8  # inputs rotated in the timings (8 x 75 MB > L2)


def score_inputs(torch, gen, logits_hw, embed_hw, n: int):
    """``n`` (logits, embedding) pairs as the hyperbolic head returns them:
    float32 logits of 19 classes (normal x 3) and a float32 64-wide ball
    embedding, radii uniform in [0, 0.95)."""
    out = []
    for _ in range(n):
        lg = torch.randn(tuple(logits_hw) + (19,), generator=gen,
                         device=DEVICE) * 3.0
        out.append((lg, ball_points(torch, tuple(embed_hw) + (64,), gen,
                                    dtype=torch.float32)))
    return out


def score_yardstick(torch, lg, em, native, dtype):
    """The score stage as a composite of PyTorch calls: F.interpolate
    (bilinear, align_corners), the entropy, torch.linalg.vector_norm and
    atanh, a 3x3 avg_pool2d x 9 and aminmax normalisation."""
    import torch.nn.functional as F

    def up(x):
        return F.interpolate(x.permute(2, 0, 1)[None], size=native,
                             mode="bilinear", align_corners=True)[0].to(
                                 dtype).float()
    x = up(lg).clamp(-60.0, 60.0)
    e = x.exp()
    s, t = e.sum(0), (x * e).sum(0)
    ent = (s.log() - t / s) / math.log(19.0)
    norm = torch.linalg.vector_norm(up(em), dim=0).clamp_min(1e-15)
    rad = 2.0 * torch.atanh(norm.clamp_max(1 - 1e-7))
    unc = F.avg_pool2d(ent[None, None], 3, stride=1, padding=1)[0, 0] * 9.0

    def normalize(m):
        lo, hi = torch.aminmax(m)
        return (m - lo) / (hi - lo)
    unc, rad = normalize(unc), normalize(rad)
    return rad * unc, rad, unc


def entropy_scale(torch, lg, native, dtype):
    """Per native pixel, log(sum e^v) / log 19 of the upsampled, cast and
    clamped logits v: the larger operand of the entropy's last subtraction
    (log s - t / s) / log 19. Float32 sums in another order move each
    operand by a few units in its last place, so near-certain pixels (a
    small entropy cancelled from a large log s) lose relative accuracy."""
    from halo_tpu_torch.ops.resize import device_table, resize_by_table
    dev = lg.device
    up = resize_by_table(lg.float(), device_table(native[0], lg.shape[0], dev),
                         device_table(native[1], lg.shape[1], dev))
    up = up.to(dtype).float().clamp(-60.0, 60.0)
    return torch.logsumexp(up, dim=-1).abs() / math.log(19.0)


def entropy_err(torch, got, want, scale) -> tuple:
    """(largest |got - want| over max(want, scale), largest relative diff,
    share of pixels beyond 2e-6 relative)."""
    diff = (got - want).abs()
    return (float((diff / torch.maximum(want.abs(), scale)).max()),
            max_rel(torch, got, want),
            float((diff > 2e-6 * want.abs()).float().mean()))


def hold_score_maps(torch, lg, em, native, label) -> float:
    """The score kernels on one image's real head outputs, held in two
    parts, each well conditioned: S1's raw maps (region_maps) against
    the plain version's (the windowed uncertainty within 1e-5 of its
    largest value, the radius in t = tanh(r/2) within 1e-6), and S2's
    normalised maps against the normalisation of S1's own raw maps in
    torch (within 1e-6). The normalised maps against the plain version's
    are printed, not held: at a seeded random init the entropy is near
    log 19 everywhere, and dividing by its small range magnifies the
    rounding of the channel sums. Returns the largest S2 difference."""
    from halo_tpu_torch.active import cuda_score
    from halo_tpu_torch.active.scoring import normalize_map
    kw = dict(score_dtype=torch.bfloat16)
    unc, rad = cuda_score.region_maps(lg, em, native, **kw)
    unc_p, rad_p = cuda_score.region_maps_plain(lg, em, native, **kw)
    maps = cuda_score.region_score(lg, em, native, **kw)
    plain = cuda_score.region_score_plain(lg, em, native, **kw)
    torch.cuda.synchronize()
    unc_err = float((unc - unc_p).abs().max() / unc_p.abs().max())
    t_diff = float((torch.tanh(rad / 2) - torch.tanh(rad_p / 2)).abs().max())
    imp_n, unc_n = normalize_map(rad), normalize_map(unc)
    s2_err = max(float((a - b).abs().max())
                 for a, b in zip(maps, (imp_n * unc_n, imp_n, unc_n)))
    vs_plain = max(float((a - b).abs().max()) for a, b in zip(maps, plain))
    print(f"{label}: S1's raw uncertainty within {unc_err:.3e} of its largest "
          f"value and radius within {t_diff:.3e} in tanh(r/2) of the plain "
          f"version's; S2's maps within {s2_err:.3e} of torch's "
          f"normalisation of S1's maps; the normalised maps against the "
          f"plain version's: max abs diff {vs_plain:.3e} (range of the "
          f"uncertainty {float(unc_p.max() - unc_p.min()):.3e})", flush=True)
    if unc_err > 1e-5 or t_diff > 1e-6 or s2_err > 1e-6:
        raise AssertionError(f"the score kernels off their plain version on "
                             f"the {label}")
    return s2_err


def phase_score(torch, gen, report):
    """The score kernel pair (S1 + S2, csrc/region_score.cu) against its
    plain version on the card: the round's 1024x2048, ACDC's 1080x1920
    and a ragged shape, score dtype bf16 and float32. Gates: the entropy
    within 2e-6 relative to the larger of itself and log(sum e^v) / log 19
    (``entropy_scale``: plain 2e-6 relative fails where a near-certain
    pixel's small entropy is cancelled from a large log s; the plain
    relative difference and the share of pixels beyond it are printed)
    and the radius in t = tanh(r/2) within 1e-6 (pixel_entropy, not
    normalised: the kernel's raw maps), score, impurity and uncertainty
    within 1e-5 absolute. Prints the share of
    kernel A's picks the two score maps have in common; times the pair,
    the plain version and the yardstick composite (8 images in turn),
    each beside the bound from the bytes; counts the device kernels of one
    round's call from the profiler."""
    from halo_tpu_torch.active import cuda_score, cuda_select
    from halo_tpu_torch.active.scoring import fused_upsample_region_score
    worst = 0.0
    timed = {}
    for label, native, lhw, ehw, picks in SCORE_CASES:
        lg, em = score_inputs(torch, gen, lhw, ehw, 1)[0]
        for dtype in (torch.bfloat16, torch.float32):
            name = f"{label} {native[0]}x{native[1]} {str(dtype)[6:]}"
            kw = dict(score_dtype=dtype, halo=0)
            ent, rad = cuda_score.region_maps(lg, em, native, **kw)
            ent_p, rad_p = cuda_score.region_maps_plain(lg, em, native, **kw)
            got = cuda_score.region_score(lg, em, native, score_dtype=dtype)
            want = cuda_score.region_score_plain(lg, em, native,
                                                 score_dtype=dtype)
            torch.cuda.synchronize()
            ent_rel, ent_plain_rel, ent_share = entropy_err(
                torch, ent, ent_p, entropy_scale(torch, lg, native, dtype))
            t_diff = float((torch.tanh(rad / 2) - torch.tanh(rad_p / 2))
                           .abs().max())
            errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
            kw = dict(num_picks=picks, mask_radius=5)
            pk = cuda_select.greedy_picks(got[0], **kw)[0]
            pk_p = cuda_select.greedy_picks(want[0], **kw)[0]
            common = len(set(map(tuple, pk.tolist()))
                         & set(map(tuple, pk_p.tolist()))) / picks
            print(f"score {name}: entropy max diff {ent_rel:.3e} of "
                  f"max(itself, log s / log 19) (plain relative "
                  f"{ent_plain_rel:.3e}, {ent_share:.2e} of the pixels "
                  "beyond 2e-6 relative), radius "
                  f"max |t| diff {t_diff:.3e}; score / impurity / "
                  f"uncertainty max abs diff {errs[0]:.3e} / {errs[1]:.3e} "
                  f"/ {errs[2]:.3e}; kernel A's picks common to the two "
                  f"score maps {common:.4f}", flush=True)
            if ent_rel > 2e-6 or t_diff > 1e-6 or max(errs) > 1e-5:
                raise AssertionError(f"the score kernels off their plain "
                                     f"version at {name}")
            worst = max(worst, *errs)
            if label != "ragged":
                timed[name] = (native, lhw, ehw, dtype)
    ms = {}
    for name, (native, lhw, ehw, dtype) in timed.items():
        imgs = score_inputs(torch, gen, lhw, ehw, SCORE_IMAGES)
        n_in = 4 * (lhw[0] * lhw[1] * 19 + ehw[0] * ehw[1] * 64)
        n_px = native[0] * native[1]
        b_ms, b_by = bound_ms(n_in + 3 * 4 * n_px, n_px * (11 * 19 + 8 * 64))
        k = cuda_ms(torch, lambda i: cuda_score.region_score(
            *imgs[i % SCORE_IMAGES], native, score_dtype=dtype), 24)
        pl = cuda_ms(torch, lambda i: cuda_score.region_score_plain(
            *imgs[i % SCORE_IMAGES], native, score_dtype=dtype), 8)
        yd = cuda_ms(torch, lambda i: score_yardstick(
            torch, *imgs[i % SCORE_IMAGES], native, dtype), 8)
        ms[name] = (k, pl, yd, b_ms, b_by)
        print(f"score {name}: kernels S1 + S2 {k:.4f} ms, plain "
              f"{pl:.4f} ms, yardstick (F.interpolate, entropy, "
              f"vector_norm + atanh, avg_pool2d, aminmax) {yd:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}; {100 * b_ms / k:.0f}% of the "
              "bound)", flush=True)
        del imgs
    # the round's call: device kernels a call, from the profiler
    lg, em = score_inputs(torch, gen, (640, 1280), (160, 320), 1)[0]
    fused_upsample_region_score(lg, em, (1024, 2048))
    events, _ = profiled(torch, lambda: fused_upsample_region_score(
        lg, em, (1024, 2048), score_dtype=torch.bfloat16))
    print(f"score: the round's call (1024x2048 bf16) runs "
          f"{sum(e.count for e in events)} device kernels: " + json.dumps(
              {e.key[:60]: [e.count, round(e.self_device_time_total / 1e3, 4)]
               for e in events}), flush=True)
    k, pl, yd, b_ms, b_by = next(iter(ms.values()))  # cityscapes, bf16
    report["region_score"] = {
        "name": "region_score", "route": "cuda",
        "source": "halo_tpu_torch/csrc/region_score.cu",
        "replaces": "halo_tpu/active/pallas_radius.py:100",
        "launches": 0, "max_abs_err": worst, "ms": k, "plain_ms": pl,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


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
    sums decides which way a bf16 output rounds (``tools/wgrad_probe``)."""
    from halo_tpu_torch.tools import wgrad_probe
    return wgrad_probe.bf16_steps(got, want)


def check_conv(torch, dc, x, wt, g, d, label) -> dict:
    """Kernel C's forward, dx and dk against the plain version, through
    autograd of each. bf16: at
    most one bf16 step apart beyond 1e-5 of max|out| (dk: of wgrad_taps on
    float32 operands, the sums the kernel rounds once); f32: within 1e-5
    of max|out|. A bf16 dk beyond that prints its worst element against
    the float32 and the float64 sums (wgrad_taps on the operands widened
    exactly) and that element's sum of |terms|. Returns the largest
    absolute difference of each part."""
    from halo_tpu_torch.tools import wgrad_probe
    xk = x.detach().clone().requires_grad_(True)
    wk = wt.detach().clone().requires_grad_(True)
    got = dc.dilated_conv3x3(xk, wk, d)
    got.backward(g)
    xp = x.detach().clone().requires_grad_(True)
    wp = wt.detach().clone().requires_grad_(True)
    want = dc.dilated_conv3x3_plain(xp, wp, d)
    want.backward(g)
    if x.dtype == torch.bfloat16:
        want_dk = dc.wgrad_taps(x.float(), g.float(), d)
    else:
        want_dk = wp.grad
    torch.cuda.synchronize()
    errs = {}
    for part, a, e in (("fwd", got, want), ("dx", xk.grad, xp.grad),
                       ("dk", wk.grad, want_dk)):
        a, e = a.detach(), e.detach()
        err = float((a.float() - e.float()).abs().max())
        errs[part] = err
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
        if not ok and part == "dk" and x.dtype == torch.bfloat16:
            print(f"conv {label} dk: " + wgrad_probe.dk_worst(
                a, e, x.detach(), g.detach(), d), flush=True)
        if not ok:
            raise AssertionError(f"kernel C {part} off its plain version "
                                 f"at {label}: {detail}")
    return errs


def dk_plan_line(torch, dc, b, c, h, w, d) -> str:
    """The weight-gradient kernel's split of a call on this card and the
    L2 bytes it reckons: operands into shared memory, float32 partials out
    and back."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = dc.wgrad_plan(b, h, w, c, c, d, sms)
    return (f"plan P = {plan.period}, G = {plan.grid} blocks of {sms} SMs, "
            f"{plan.tiles} tiles x {plan.steps} pixel steps; L2 operand "
            f"bytes {plan.operand_bytes() / 1e6:.1f} MB, partials "
            f"{plan.partial_bytes() / 1e6:.1f} MB")


def phase_conv(torch, gen, report):
    """Kernel C at the main path's shapes (B = 2: 90x160 the source's,
    80x160 the target's) against its plain version, forward, dx and dk;
    times kernel, plain version and cuDNN."""
    import torch.nn.functional as F
    from halo_tpu_torch.ops import dilated_conv as dc

    # (channels, d, dtype, H): R101 layer3 (256) and layer4 (512)
    cases = [(256, 2, torch.bfloat16, 90), (512, 2, torch.bfloat16, 90),
             (512, 4, torch.bfloat16, 90), (256, 2, torch.bfloat16, 80),
             (512, 4, torch.bfloat16, 80), (256, 2, torch.float32, 90)]
    # One launch of each kernel, synchronised at once: a kernel that hangs
    # or faults shows here, not in a later phase.
    x = torch.randn((1, 64, 8, 40), generator=gen, device=DEVICE)
    x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    dc._conv(x, torch.zeros((64, 64, 3, 3), dtype=torch.bfloat16,
                            device=DEVICE), 1)
    torch.cuda.synchronize()
    xh = dc._nhwc(x)
    dc._wgrad(xh, xh, 1)
    torch.cuda.synchronize()
    print("conv: first bf16 forward and dk launches ran", flush=True)
    worst, worst_dk = 0.0, 0.0
    rows = {}
    for c, d, dtype, h in cases:
        w = 160
        label = f"{c}ch d={d} {h}x{w} {str(dtype).split('.')[-1]}"
        bf16 = dtype == torch.bfloat16
        x = torch.randn((2, c, h, w), generator=gen, device=DEVICE)
        x = x.to(dtype).contiguous(memory_format=torch.channels_last)
        # channels_last, as the port's models hold their weights on CUDA
        wt = (torch.randn((c, c, 3, 3), generator=gen, device=DEVICE)
              / math.sqrt(9 * c)).to(dtype).contiguous(
                  memory_format=torch.channels_last)
        g = torch.randn((2, c, h, w), generator=gen, device=DEVICE)
        g = g.to(dtype).contiguous(memory_format=torch.channels_last)
        errs = check_conv(torch, dc, x, wt, g, d, label)
        worst = max(worst, errs["fwd"], errs["dx"])
        xh, gh = dc._nhwc(x), dc._nhwc(g)
        if bf16:
            a, b = dc._wgrad(xh, gh, d), dc._wgrad(xh, gh, d)
            if not torch.equal(a.view(torch.int16), b.view(torch.int16)):
                raise AssertionError(f"dk at {label}: two calls differ")
            worst_dk = max(worst_dk, errs["dk"])
        with torch.no_grad():
            ms = cuda_ms(torch, lambda i: dc._conv(x, wt, d), 50)
            ms_dx = cuda_ms(torch, lambda i: dc._launch(
                gh, dc.repack_flipped(wt, kmajor=bf16), c, d), 50)
            plain = cuda_ms(
                torch, lambda i: dc.dilated_conv3x3_plain(x, wt, d), 10)
            lib = cuda_ms(torch, lambda i: F.conv2d(
                x, wt, padding=d, dilation=d), 50)
            # cuDNN's dgrad and wgrad as autograd runs them in the model
            # (torch.nn.grad.conv2d_input's stand-in input of stride 0
            # would send it to a slower, non-channels-last dgrad)
            def conv_backward(mask):
                return torch.ops.aten.convolution_backward(
                    g, x, wt, None, [1, 1], [d, d], [d, d], False,
                    [0, 0], 1, mask)
            lib_dx = cuda_ms(
                torch, lambda i: conv_backward([True, False, False]), 50)
            taps = cuda_ms(torch, lambda i: dc.wgrad_taps(x, g, d), 20)
            dk = cuda_ms(torch, lambda i: dc._wgrad(xh, gh, d), 50) \
                if bf16 else taps
            lib_dk = cuda_ms(
                torch, lambda i: conv_backward([False, True, False]), 20)
        flops = 2 * 2 * h * w * 9 * c * c
        nbytes = (2 * 2 * h * w * c + 9 * c * c) * x.element_size()
        rate = BF16_FLOP_PER_S if bf16 else F32_FLOP_PER_S
        b_ms, b_by = bound_ms(nbytes, flops, rate)
        # dk reads x and the cotangent once and writes the 9 taps
        dk_ms, dk_by = bound_ms((2 * 2 * 2 * h * w * c + 9 * c * c)
                                * x.element_size(), flops, rate)
        if bf16:
            split = kernel_ms(torch, lambda: dc._wgrad(xh, gh, d),
                              ("wgrad",))
            print(f"conv {label} dk: kernel {dk:.4f} ms, cuDNN wgrad "
                  f"{lib_dk:.4f} ms, bound {dk_ms:.4f} ms ({dk_by}), "
                  f"{dk_ms / dk:.1%} of the bound; kernels (profiler, ms a "
                  "call) " + json.dumps({k: round(v, 4)
                                         for k, v in split.items()})
                  + "; " + dk_plan_line(torch, dc, 2, c, h, w, d), flush=True)
        dk_what = ("dk kernel (split-K TMA + wgmma, one launch) "
                   f"{dk:.4f} ms ({flops / dk / 1e9:.1f} "
                   f"TFLOP/s), wgrad_taps (pad, 9 slab copies, 9 torch.mm) "
                   f"{taps:.4f} ms" if bf16 else
                   f"dk (wgrad_taps: pad, 9 slab copies, 9 torch.mm) "
                   f"{dk:.4f} ms")
        print(f"conv {label} (2, {c}, {h}, {w}): kernel fwd {ms:.4f} ms, dx "
              f"{ms_dx:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s fwd), plain "
              f"{plain:.4f} ms, F.conv2d (cuDNN, channels_last) {lib:.4f} "
              f"ms, cuDNN dgrad (convolution_backward) {lib_dx:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}); {dk_what}, cuDNN wgrad "
              f"(convolution_backward) {lib_dk:.4f} ms, dk bound "
              f"{dk_ms:.4f} ms "
              f"({dk_by}, {dk_ms / dk:.0%} of it)", flush=True)
        rows[label] = (ms, plain, b_ms, b_by, lib, dk, taps, dk_ms, dk_by,
                       lib_dk)
    ms, plain, b_ms, b_by, lib = rows["256ch d=2 90x160 bfloat16"][:5]
    report["dilated_conv3x3"] = {
        "name": "dilated_conv3x3", "route": "cuda",
        "source": "halo_tpu_torch/csrc/dilated_conv.cu",
        "replaces": "halo_tpu/ops/pallas_conv.py:150",
        "launches": 0, "max_abs_err": worst, "ms": ms, "plain_ms": plain,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}
    dk, taps, dk_ms, dk_by, lib_dk = rows["256ch d=2 90x160 bfloat16"][5:]
    report["dilated_conv3x3_wgrad"] = {
        "name": "dilated_conv3x3_wgrad", "route": "cuda",
        "source": "halo_tpu_torch/csrc/dilated_conv_wgrad.cu",
        "replaces": "halo_tpu/ops/pallas_conv.py:180",
        "launches": 0, "max_abs_err": worst_dk, "ms": dk, "plain_ms": taps,
        "bound_ms": dk_ms, "bound_by": dk_by, "library_ms": lib_dk}


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


def summarize_profile(prof, wall_s: float, path: str) -> dict:
    """Device busy time against the round's wall clock, and the kernels
    that take it, from a torch.profiler run; the trace goes to ``path``.
    Returns the device ms of each kernel name."""
    from torch.autograd import DeviceType
    prof.export_chrome_trace(path)
    # device-side events only: kernels and copies (the CPU ops that launch
    # them carry the same time again; conv_ranges' device-side ranges too)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0
              and not e.key.startswith(RANGE_PREFIX)]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"profile: device busy {busy_ms:.1f} ms of {wall_s * 1e3:.1f} ms "
          f"wall (idle share {1 - busy_ms / (wall_s * 1e3):.3f}); trace "
          f"{path}", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x "
              f"{e.key[:90]}", flush=True)
    return {e.key: e.self_device_time_total / 1e3 for e in events}


def phase_slice(torch, args, report):
    from halo_tpu_torch.active import cuda_radius, cuda_score, cuda_select
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
        cuda_score.launches = cuda_score.launches_s2 = 0
        stages = {}
        with profiler as prof:
            t0 = time.perf_counter()
            stats = region_selection(cfg, model, build_active_loader(cfg), 0,
                                     device=DEVICE, stage_seconds=stages)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {"region_score": cuda_score.launches,
                    "greedy_picks": cuda_select.launches}
        s2_launches, b_launches = cuda_score.launches_s2, cuda_radius.launches
        n = stats["images"]
        per_img = {k: v / max(n, 1) * 1e3 for k, v in sorted(stages.items())}
        print(f"round 0: {stats}; {wall / max(n, 1) * 1e3:.1f} ms/img wall; "
              "stages ms/img " + json.dumps(
                  {k: round(v, 3) for k, v in per_img.items()}), flush=True)
        print(f"launches on the main path: {launches}; S2 {s2_launches}, "
              f"kernel B {b_launches}", flush=True)
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
        if (launches["region_score"] != n or s2_launches != n
                or b_launches != 0):
            raise AssertionError(f"the score kernels S1 {launches} S2 "
                                 f"{s2_launches} and kernel B {b_launches} "
                                 f"times for {n} images (want S1 and S2 "
                                 "once an image, B never)")
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
            score = fused_upsample_region_score(
                logits[0], embed[0], (1024, 2048),
                score_dtype=torch.bfloat16)[0]
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
        with torch.no_grad():
            map_err = hold_score_maps(torch, logits[0], embed[0],
                                      (1024, 2048), "first image's real maps")
        report["region_score"]["max_abs_err"] = max(
            report["region_score"]["max_abs_err"], map_err)
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


# Profiler ranges that conv_ranges puts around kernel C's wrapper calls:
# range -> the ops/dilated_conv.py functions it wraps (those that exist).
RANGE_PREFIX = "halo/"
CONV_RANGES = (
    ("forward", ("_DilatedConv3x3.forward",)),
    ("backward", ("_DilatedConv3x3.backward",)),
    ("launch", ("_launch",)),             # the fwd and dx kernel calls
    ("dk", ("wgrad_taps", "_wgrad")),    # the weight gradient
    ("repack", ("repack", "repack_kmajor", "repack_flipped")),
    ("layout", ("_nhwc",)))
# Kernel C's own kernels, by the name the profiler gives them.
CONV_KERNELS = ("conv_bf16_kernel", "conv_f32_kernel", "wgrad_bf16_kernel")


@contextlib.contextmanager
def conv_ranges(torch):
    """Name kernel C's wrapper calls as torch.profiler ranges (CONV_RANGES),
    so that a trace splits a step's kernel-C time by wrapper function."""
    from torch.profiler import record_function

    from halo_tpu_torch.ops import dilated_conv as dc
    undo = []
    for rng, names in CONV_RANGES:
        for name in names:
            owner, attr = (dc._DilatedConv3x3, name.split(".")[1]) \
                if "." in name else (dc, name)
            fn = owner.__dict__.get(attr)
            if fn is None:
                continue
            inner = fn.__func__ if isinstance(fn, staticmethod) else fn

            def wrapped(*a, _inner=inner, _rng=rng, **k):
                with record_function(RANGE_PREFIX + _rng):
                    return _inner(*a, **k)
            setattr(owner, attr, staticmethod(wrapped)
                    if isinstance(fn, staticmethod) else wrapped)
            undo.append((owner, attr, fn))
    try:
        yield
    finally:
        for owner, attr, fn in undo:
            setattr(owner, attr, fn)


def print_conv_ranges(prof, steps: int):
    """Device and host ms a step of each conv_ranges range, and of kernel
    C's own kernels. A range's device time is that of the PyTorch ops
    inside it (copies, GEMMs, casts); the kernels launched through ctypes
    are not attributed to it and are listed by name."""
    from torch.autograd import DeviceType
    ranges, own = {}, {}
    for e in prof.key_averages():
        dev = getattr(e, "device_time_total", None)
        if dev is None:
            dev = e.cuda_time_total
        if e.device_type == DeviceType.CPU and e.key.startswith(
                RANGE_PREFIX):
            ranges[e.key[len(RANGE_PREFIX):]] = [
                round(dev / 1e3 / steps, 3),
                round(e.cpu_time_total / 1e3 / steps, 3),
                e.count / steps]
        elif e.device_type == DeviceType.CUDA:
            for name in CONV_KERNELS:
                if name in e.key:
                    t = own.setdefault(name, [0.0, 0])
                    t[0] += e.self_device_time_total / 1e3 / steps
                    t[1] += e.count / steps
    if ranges:
        print("profile: kernel C's wrapper, a step (device ms of its "
              "PyTorch ops / host ms / calls): " + json.dumps(ranges),
              flush=True)
    print("profile: kernel C's kernels, a step (device ms / launches): "
          + json.dumps({k: [round(v[0], 3), v[1]] for k, v in own.items()}),
          flush=True)


def fixed_batches(learner) -> dict:
    """One batch of each train loader, on the device."""
    return {k: learner._to_device(next(iter(v)))
            for k, v in learner.train_loaders().items()}


def fixed_batch_ms(torch, learner, batches, steps: int = 5) -> list:
    """ms of ``steps`` train steps on one device-resident batch (no
    loader), each between its own pair of CUDA events and synchronised,
    after one untimed step."""
    learner.train_step(batches)
    torch.cuda.synchronize()
    times = []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        learner.train_step(batches)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def profile_steps(torch, learner, path: str, steps: int = 3, batches=None):
    """Device time of ``steps`` train steps on one fixed batch (no loader),
    traced with torch.profiler, kernel C's wrapper split by conv_ranges;
    the trace goes next to ``path``."""
    from torch.profiler import ProfilerActivity, profile
    mode = learner.cfg.TPU.DENSE_CONV_MODE
    if batches is None:
        batches = fixed_batches(learner)
    learner.train_step(batches)
    torch.cuda.synchronize()
    with conv_ranges(torch), profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            learner.train_step(batches)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(f"profile: {steps} train steps ({mode}) on a fixed batch, "
          f"{wall / steps * 1e3:.1f} ms/step", flush=True)
    by_kernel = summarize_profile(prof, wall, str(Path(path).with_suffix(
        f".train_{mode}.json")))
    print_conv_ranges(prof, steps)
    return {k: v / steps for k, v in by_kernel.items()}


def phase_train(torch, args, report):
    """The source_target learner through halo_tpu_torch.train.main: round 1
    at step 0, ``TRAIN_STEPS`` train steps, validation, checkpoints; then
    the same steps with cuDNN convs for comparison."""
    import statistics

    from halo_tpu_torch import train
    from halo_tpu_torch.active import cuda_radius, cuda_score, cuda_select
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
        dc.launches_fwd = dc.launches_dx = dc.launches_dk = 0
        dc.layout_copies = 0
        cuda_radius.launches = cuda_select.launches = 0
        cuda_score.launches = 0
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
                  "dk": dc.launches_dk, "layout_copies": dc.layout_copies,
                  "radius_map": cuda_radius.launches,
                  "region_score": cuda_score.launches,
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
        # Kernel C: 25 convs, forward, dx and dk, in each of a step's two
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
              f"{counts['dx']} dx and {counts['dk']} dk (want {want_dx} "
              f"each: {2 * n_conv} a step); layout copies "
              f"{counts['layout_copies'] / TRAIN_STEPS:.1f} a step",
              flush=True)
        if (n_conv != 25 or counts["fwd"] != want_fwd
                or counts["dx"] != want_dx or counts["dk"] != want_dx
                or counts["radius_map"] != 0
                or counts["region_score"] != len(entries)
                or counts["greedy_picks"] <= 0):
            raise AssertionError(f"kernel launches on the train path: "
                                 f"{counts}")
        report["dilated_conv3x3"]["launches"] = counts["fwd"] + counts["dx"]
        report["dilated_conv3x3_wgrad"]["launches"] = counts["dk"]
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
        shutil.copy(Path(cfg.SAVE_DIR) / "last.ckpt",
                    report["work"] / "r101_last.ckpt")  # for phase int8
        # Kernel C on the first step's real tensors.
        for name, e in (("layer3", captured[256]), ("layer4", captured[512])):
            errs = check_conv(torch, dc, e["x"], e["w"], e["g"], e["d"],
                              f"train step 0, {name} conv2")
            for key, parts in (("dilated_conv3x3", ("fwd", "dx")),
                               ("dilated_conv3x3_wgrad", ("dk",))):
                report[key]["max_abs_err"] = max(
                    report[key]["max_abs_err"], *(errs[p] for p in parts))

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
        batches = fixed_batches(learner)
        fixed = {"pallas": fixed_batch_ms(torch, learner, batches)}
        print(f"train ms/step (pallas) on a fixed device-resident batch, "
              f"CUDA events, no loader: median "
              f"{statistics.median(fixed['pallas']):.2f} of "
              + json.dumps([round(t, 2) for t in fixed["pallas"]]),
              flush=True)
        if args.profile:
            by_kernel = {"pallas": profile_steps(torch, learner, args.profile,
                                                 batches=batches)}
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
        # the same device-resident batch as the pallas steps
        fixed["conv"] = fixed_batch_ms(torch, learner, batches)
        med = {k: statistics.median(v) for k, v in fixed.items()}
        print(f"train ms/step (conv) on a fixed device-resident batch, "
              f"CUDA events, no loader: median {med['conv']:.2f} of "
              + json.dumps([round(t, 2) for t in fixed["conv"]])
              + f"; pallas / conv {med['pallas'] / med['conv']:.3f}",
              flush=True)
        if args.profile:
            by_kernel["conv"] = profile_steps(torch, learner, args.profile,
                                              batches=batches)
            diff = {k: by_kernel["pallas"].get(k, 0.0)
                    - by_kernel["conv"].get(k, 0.0)
                    for k in set(by_kernel["pallas"]) | set(by_kernel["conv"])}
            print("profile: device ms a step, pallas less conv, by kernel "
                  f"(sum {sum(diff.values()):+.3f}):", flush=True)
            for k in sorted(diff, key=lambda k: -abs(diff[k]))[:20]:
                print(f"  {diff[k]:+8.3f} ms {k[:100]}", flush=True)
        del learner, batches
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
    from halo_tpu_torch.active import cuda_radius, cuda_score, cuda_select
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
                "dk": dc.launches_dk, "radius_map": cuda_radius.launches,
                "region_score": cuda_score.launches,
                "greedy_picks": cuda_select.launches}

    def zero_counts():
        dc.launches_fwd = dc.launches_dx = dc.launches_dk = 0
        dc.layout_copies = 0
        cuda_radius.launches = cuda_select.launches = 0
        cuda_score.launches = 0

    def expect(label, got, want):
        # every backward needs dx and dk; the score pair runs in rounds
        want = {"region_score": 0, **want, "dk": want["dx"]}
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
        expect("(b) source_free", got, {
            "fwd": n_conv * (steps + batches), "dx": n_conv * steps,
            "radius_map": 0, "region_score": args.images,
            "greedy_picks": batches})
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
        # kernel B's path since the round scores with S1 + S2: the test
        # entry's rich eval step
        report["radius_map"]["launches"] += got["radius_map"]
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
    from halo_tpu_torch.active import cuda_radius, cuda_score, cuda_select
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
                "dk": dc.launches_dk, "radius_map": cuda_radius.launches,
                "region_score": cuda_score.launches,
                "greedy_picks": cuda_select.launches}

    def zero_counts():
        dc.launches_fwd = dc.launches_dx = dc.launches_dk = 0
        dc.layout_copies = 0
        cuda_radius.launches = cuda_select.launches = 0
        cuda_score.launches = 0

    def expect(label, got, want):
        # every backward needs dx and dk; the score pair runs in rounds
        want = {"region_score": 0, **want, "dk": want["dx"]}
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
        expect("(f) deeplabv2 hyper", got, {
            "fwd": n_conv * (2 * steps + batches), "dx": 2 * n_conv * steps,
            "radius_map": 0, "region_score": args.images,
            "greedy_picks": batches})
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
    from halo_tpu_torch.active import cuda_radius, cuda_score, cuda_select
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
                "dk": dc.launches_dk, "radius_map": cuda_radius.launches,
                "region_score": cuda_score.launches,
                "greedy_picks": cuda_select.launches}

    def zero_counts():
        dc.launches_fwd = dc.launches_dx = dc.launches_dk = 0
        dc.layout_copies = 0
        cuda_radius.launches = cuda_select.launches = 0
        cuda_score.launches = 0

    def expect(label, got, want):
        # every backward needs dx and dk; the score pair runs in rounds
        want = {"region_score": 0, **want, "dk": want["dx"]}
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
        expect("acdc train", got, {"fwd": 0, "dx": 0, "radius_map": 0,
                                   "region_score": n_img,
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
            score = fused_upsample_region_score(
                logits[0], embed[0], (h_nat, w_nat),
                score_dtype=torch.bfloat16)[0]
            s_err = hold_score_maps(torch, logits[0], embed[0],
                                    (h_nat, w_nat), "acdc first image")
            kw = dict(num_picks=picks, mask_radius=cfg.ACTIVE.MASK_RADIUS_K)
            a_got = cuda_select.greedy_picks(score, **kw)
            t0 = time.perf_counter()
            a_want = cuda_select.greedy_picks_reference(score, **kw)
            torch.cuda.synchronize()
            a_plain = (time.perf_counter() - t0) * 1e3
            native = resize_bilinear(embed[0].float(), (h_nat, w_nat))
            native = native.to(torch.bfloat16)
        report["region_score"]["max_abs_err"] = max(
            report["region_score"]["max_abs_err"], s_err)
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
        shutil.copy(ckpt, report["work"] / "mitb4_last.ckpt")  # phase int8
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


INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core rate, H100 SXM
# phase int8 (1): (label, Cin, Cout, H, W, kernel, stride, dilation) of
# kernel I's k x k calls on the main path: R101 at a 640x1280 input
# (layer1 at 160x320, the trunk at 80x160), MiT-B4's pe3 on its 80x160
# stage-2 map; each at the test entry's flip pair and the sweep's batch
INT8_CASES = (
    ("R101 layer1 3x3 64", 64, 64, 160, 320, 3, 1, 1),
    ("R101 layer2.0 3x3 128 s2", 128, 128, 160, 320, 3, 2, 1),
    ("R101 layer2 3x3 128", 128, 128, 80, 160, 3, 1, 1),
    ("R101 layer3 3x3 256 d2", 256, 256, 80, 160, 3, 1, 2),
    ("R101 layer4 3x3 512 d4", 512, 512, 80, 160, 3, 1, 4),
    ("ASPP bottleneck 3x3 2560->512", 2560, 512, 80, 160, 3, 1, 1),
    ("MiT-B4 pe3 3x3 s2 128->320", 128, 320, 80, 160, 3, 2, 1),
)
INT8_BATCHES = (2, 4)
# (label, M, K, N) of the 1x1 convs and dense layers (one-tap GEMMs of
# kernel I) at a 640x1280 input
INT8_GEMMS = (
    ("R101 layer3 conv1 1024->256, B 2", 2 * 80 * 160, 1024, 256),
    ("R101 layer3 conv3 256->1024, B 2", 2 * 80 * 160, 256, 1024),
    ("ASPP global branch 2048->512, B 2", 2, 2048, 512),
    ("decoder.0 pointwise 560->512, B 2", 2 * 160 * 320, 560, 512),
    ("MiT-B4 stage-1 fc2 256->64, B 2", 2 * 160 * 320, 256, 64),
    ("MiT-B4 stage-3 fc1 320->1280, B 2", 2 * 40 * 80, 320, 1280),
)


# phase int8 (1): (label, C, H, W) of the maps a frozen norm and ReLU feed
# into kernel Q at R101's fused sites for a 640x1280 input (each
# bottleneck's conv2 and conv3 inputs, layer2.0's strided conv2 reading
# 160x320; the ASPP branches' and the decoder's pointwise convs)
FUSED_SITES = (
    ("R101 layer1 site 64", 64, 160, 320),
    ("R101 layer2.0 conv2 site 128", 128, 160, 320),
    ("R101 layer2 site 128", 128, 80, 160),
    ("R101 layer3 site 256", 256, 80, 160),
    ("R101 layer4 site 512", 512, 80, 160),
    ("ASPP pointwise site 2048", 2048, 80, 160),
    ("decoder.0 pointwise site 560", 560, 160, 320),
    ("decoder.1 pointwise site 512", 512, 160, 320),
)


def first_source(x):
    """A QuantConv's input tensor, or the first of its sources."""
    return x[0] if isinstance(x, (list, tuple)) else x


def frozen_bn(torch, gen, c):
    """A FrozenBatchNorm2d on the device with random statistics."""
    from halo_tpu_torch.models.layers import FrozenBatchNorm2d
    bn = FrozenBatchNorm2d(c).to(DEVICE)
    with torch.no_grad():
        bn.weight.copy_(torch.rand((c,), generator=gen, device=DEVICE) + 0.5)
        bn.bias.copy_(torch.randn((c,), generator=gen, device=DEVICE) * 0.3)
        bn.running_mean.copy_(torch.randn((c,), generator=gen,
                                          device=DEVICE) * 0.3)
        bn.running_var.copy_(torch.rand((c,), generator=gen,
                                        device=DEVICE) * 1.5 + 0.5)
    return bn


def int8_conv_bound(b, c, co, h, w, ho, wo, k) -> tuple:
    """bound_ms of one call of kernel I: the int8 input read once, the
    weight once, the bf16 output written once; 2 operations a
    multiply-add at the int8 rate."""
    macs = b * ho * wo * co * k * k * c
    nbytes = b * h * w * c + co * k * k * c + b * ho * wo * co * 2
    return bound_ms(nbytes, 2 * macs, INT8_OPS_PER_S)


def int8_quant_bound(x, affine: bool = False) -> tuple:
    """bound_ms of one call of kernel Q: ``x`` (a tensor or its sources,
    each element its storage holds) read once, the per-channel scale and
    shift once when ``affine``, the int8 NHWC copy (channels padded to 16)
    written once."""
    sources = x if isinstance(x, (list, tuple)) else [x]
    b, _, h, w = sources[0].shape
    c = sum(t.shape[1] for t in sources)
    read = sum(t.untyped_storage().nbytes() for t in sources)
    if affine:
        read += 2 * c * sources[0].element_size()
    return bound_ms(read + b * h * w * (c + (-c % 16)), 0.0, INT8_OPS_PER_S)


def quantize_per_tensor_nhwc(torch, x, scale: float):
    """The library call nearest kernel Q (timed here, used nowhere in the
    port): ``torch.quantize_per_tensor`` (qint8, zero point 0) of ``x``
    cast to float32 (it takes no bf16), its int8 values read as (B, H, W,
    C) (a view of channels-last storage) and padded to Q's 16-channel
    multiple, contiguous: Q's output layout."""
    import torch.nn.functional as F
    q = torch.quantize_per_tensor(x.float(), scale, 0, torch.qint8)
    return F.pad(q.int_repr().permute(0, 2, 3, 1),
                 (0, -x.shape[1] % 16)).contiguous()


def library_quant(torch, quant, x) -> tuple:
    """``quantize_per_tensor_nhwc`` at the calibrated scale of ``x`` (its
    own absmax): (ms or None, 0 or how many int8 values differ from Q's
    plain version at that scale and by how much, or the error it
    raised)."""
    amax = x.abs().amax().float()
    scale = float(quant.quantize_act(torch.zeros(1, device=x.device),
                                     amax)[1])
    try:
        got = quantize_per_tensor_nhwc(torch, x, scale)
    except (RuntimeError, NotImplementedError) as e:
        return None, f"raised {type(e).__name__}: {str(e)[:120]}"
    off = (got.int() - quant.quantize_nhwc_plain(x, amax).int()).abs()
    diff = int((off != 0).sum())
    if diff:
        diff = f"{diff} (at most {int(off.max())} apart)"
    ms = cuda_ms(torch, lambda i: quantize_per_tensor_nhwc(torch, x, scale),
                 20)
    return ms, diff


def int_mm_dequant(torch, a, w, scale, out_dtype):
    """The library yardstick of kernel I's one-tap GEMMs (timed here, used
    nowhere in the port): ``torch._int_mm`` (cuBLASLt's int8 GEMM) on
    rows padded past 16 and K, N padded to multiples of 8, then the
    dequant ``float32(sum) * scale`` cast to ``out_dtype``."""
    import torch.nn.functional as F
    m, k = a.shape
    n = w.shape[0]
    pk, pn = -k % 8, -n % 8
    if pk or m <= 16:
        a = F.pad(a, (0, pk, 0, max(0, 17 - m)))
    if pk or pn:
        w = F.pad(w, (0, pk, 0, pn))
    y = torch._int_mm(a.contiguous(), w.contiguous().t())
    return (y[:m, :n].float() * scale).to(out_dtype)


def int8_kernel_checks(torch, gen, report):
    """Phase int8 (1): kernels Q and I against their plain versions, bit
    for bit, at the path's shapes in both batches, on layouts Q meets and
    at edge cases; times Q (beside its bound) and I (beside its bound,
    its plain version, cuDNN's bf16 conv for the k x k convs and
    torch._int_mm + dequant for the one-tap GEMMs)."""
    import torch.nn.functional as F
    from halo_tpu_torch.ops import quant

    def weights(c, co, k):
        wq = torch.randint(-127, 128, (co, c, k, k), generator=gen,
                           device=DEVICE, dtype=torch.int8)
        w_scale = torch.rand((co,), generator=gen, device=DEVICE) * 1e-2
        return wq, quant.pack_weight(wq), w_scale

    def activations(b, c, h, w):
        x = torch.randn((b, c, h, w), generator=gen, device=DEVICE) * 2
        return x.to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)

    amax = torch.tensor(3.0, device=DEVICE)
    sx = quant.quantize_act(torch.zeros(1, device=DEVICE), amax)[1]
    # one small launch of each, synchronised at once: a fault shows here
    x = activations(1, 64, 9, 11)
    wq, packed, w_scale = weights(64, 64, 3)
    quant.int8_conv_kernel(quant.quantize_nhwc(x, amax), packed, w_scale,
                           amax, 3, 1, 1, 1, torch.bfloat16)
    quant.quantize_fused([x], amax, *frozen_bn(torch, gen, 64).affine(
        x.dtype), relu=True)
    torch.cuda.synchronize()
    print("int8: first launches of kernels Q (alone and with the prologue) "
          "and I ran", flush=True)
    worst, layer3, q_libs = 0.0, None, []
    for b in INT8_BATCHES:
        for label, c, co, h, w, k, s, d in INT8_CASES:
            x = activations(b, c, h, w)
            wq, packed, w_scale = weights(c, co, k)
            geo = (s, d * (k - 1) // 2, d)
            xq = quant.quantize_nhwc(x, amax)
            got = quant.int8_conv_kernel(xq, packed, w_scale, amax, k, *geo,
                                         torch.bfloat16)
            got32 = quant.int8_conv_kernel(xq, packed, w_scale, amax, k,
                                           *geo, torch.float32)
            want_q = quant.quantize_nhwc_plain(x, amax)
            want32 = quant.int8_conv_plain(
                want_q[..., :c].permute(0, 3, 1, 2), wq, sx * w_scale, *geo)
            torch.cuda.synchronize()
            if not (torch.equal(xq, want_q)
                    and torch.equal(got, want32.to(torch.bfloat16))
                    and torch.equal(got32, want32)):
                raise AssertionError(f"int8 kernels off their plain versions "
                                     f"at {label}, B {b}")
            worst = max(worst, float((got32 - want32).abs().max()))
            ho, wo = got.shape[2:]
            del got, got32, want32, want_q
            wb = torch.randn((co, c, k, k), generator=gen, device=DEVICE).to(
                torch.bfloat16).contiguous(memory_format=torch.channels_last)
            with torch.no_grad():
                ms = cuda_ms(torch, lambda i: quant.int8_conv_kernel(
                    xq, packed, w_scale, amax, k, *geo, torch.bfloat16), 20)
                plain = cuda_ms(torch, lambda i: quant.int8_conv_plain(
                    xq[..., :c].permute(0, 3, 1, 2), wq, sx * w_scale, *geo,
                    torch.bfloat16), 3, warmup=1)
                lib = cuda_ms(torch, lambda i: F.conv2d(
                    x, wb, stride=s, padding=geo[1], dilation=d), 20)
                q_ms = cuda_ms(torch, lambda i: quant.quantize_nhwc(x, amax),
                               20)
                q_plain = cuda_ms(torch, lambda i: quant.quantize_nhwc_plain(
                    x, amax), 5, warmup=1)
            b_ms, b_by = int8_conv_bound(b, c, co, h, w, ho, wo, k)
            q_bound, _ = int8_quant_bound(x)
            q_lib, q_diff = library_quant(torch, quant, x)
            q_libs.append((label, b, q_lib, q_diff))
            tops = 2 * b * ho * wo * co * k * k * c / ms / 1e9
            print(f"int8 conv {label}, B {b}: ({b}, {c}, {h}, {w}) -> "
                  f"({b}, {co}, {ho}, {wo}) bit-exact (Q; I bf16 and f32 "
                  f"out); I {ms:.4f} ms ({tops:.1f} TOPS, {b_ms / ms:.0%} "
                  f"of the bound), plain {plain:.4f} ms, cuDNN bf16 "
                  f"(channels_last) {lib:.4f} ms, bound {b_ms:.4f} ms "
                  f"({b_by}); Q (bf16 channels-last in) {q_ms:.4f} ms, "
                  f"plain {q_plain:.4f} ms, bound {q_bound:.4f} ms (bytes, "
                  f"{q_bound / q_ms:.0%}); torch.quantize_per_tensor at the "
                  f"calibrated scale (cast, int_repr, pad) "
                  + (f"{q_lib:.4f} ms, {q_diff} int8 values off Q's"
                     if q_lib is not None else str(q_diff)), flush=True)
            if layer3 is None and "layer3" in label:
                layer3 = (ms, plain, b_ms, b_by, lib, q_ms, q_plain, q_bound,
                          q_lib)
            del x, xq, wq, wb, packed, w_scale
        release(torch)
    # edge cases: odd H and W, channels no multiple of the tile or of 16,
    # a padded 1x1, a 5x5 with stride and dilation, a stride-4 sr conv
    for geo in ((1, 128, 200, 81, 161, 3, 2, 1, 1),
                (2, 48, 40, 13, 17, 3, 1, 2, 2),
                (1, 20, 70, 9, 11, 3, 1, 1, 1),
                (1, 64, 33, 7, 9, 1, 1, 1, 1),
                (2, 64, 96, 13, 17, 5, 2, 3, 2),
                (2, 128, 128, 80, 160, 4, 4, 0, 1)):
        b, c, co, h, w, k, s, p, d = geo
        x = torch.randn((b, c, h, w), generator=gen, device=DEVICE)
        wq, packed, w_scale = weights(c, co, k)
        got = quant.int8_conv(x, wq, w_scale, amax, s, p, d, torch.bfloat16,
                              packed)
        xq, _ = quant.quantize_act(x, amax)
        want = quant.int8_conv_plain(xq, wq, sx * w_scale, s, p, d,
                                     torch.bfloat16)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"int8 kernels off their plain versions at "
                                 f"edge case {geo}")
    print("int8 kernels: bit-exact at the edge cases (odd H and W; Co 200, "
          "40, 70, 33; C 48, 20; a padded 1x1; 5x5 stride 2 dilation 2; "
          "4x4 stride 4; float32 NCHW input)", flush=True)
    fused = int8_fused_checks(torch, gen, amax)
    # float input clipped beyond amax, and amax = 0, through int8_conv
    x = activations(2, 256, 80, 160)
    w_int8, w_scale = quant.quantize_weight(torch.randn(
        (256, 256, 3, 3), generator=gen, device=DEVICE))
    for a in (float(x.float().abs().max()) * 0.25, 0.0):
        a = torch.tensor(a, device=DEVICE)
        got = quant.int8_conv(x, w_int8, w_scale, a, 1, 2, 2,
                              torch.bfloat16)
        xq, sxa = quant.quantize_act(x, a)
        want = quant.int8_conv_plain(xq, w_int8, sxa * w_scale, 1, 2, 2,
                                     torch.bfloat16)
        torch.cuda.synchronize()
        clipped = float((xq.abs() == 127).float().mean())
        if not (torch.equal(got, want) and bool(torch.isfinite(got).all())):
            raise AssertionError(f"int8_conv off at amax {float(a)}")
        print(f"int8_conv on a bf16 (2, 256, 80, 160) input, amax "
              f"{float(a):.4f}: bit-exact, {clipped:.4f} of the "
              "activations at +-127", flush=True)
    for label, m, k, n in INT8_GEMMS:
        x = (torch.randn((m, k), generator=gen, device=DEVICE) * 2).to(
            torch.bfloat16)
        wq, packed, w_scale = weights(k, n, 1)
        xv = quant._channels_view(x)
        xq = quant.quantize_nhwc(xv, amax)
        got = quant.int8_conv_kernel(xq, packed, w_scale, amax, 1, 1, 0, 1,
                                     torch.bfloat16)
        a = quant.quantize_nhwc_plain(xv, amax).reshape(m, -1)[:, :k]
        want = quant.int8_gemm_plain(a, wq[:, :, 0, 0], sx * w_scale,
                                     torch.bfloat16)
        lib_out = int_mm_dequant(torch, a, wq[:, :, 0, 0], sx * w_scale,
                                 torch.bfloat16)
        torch.cuda.synchronize()
        got = got.permute(0, 2, 3, 1).reshape(m, n)
        if not (torch.equal(xq.reshape(m, -1)[:, :k], a)
                and torch.equal(got, want) and torch.equal(lib_out, want)):
            raise AssertionError(f"int8 GEMM off its plain version: {label}")
        ms = cuda_ms(torch, lambda i: quant.int8_conv_kernel(
            xq, packed, w_scale, amax, 1, 1, 0, 1, torch.bfloat16), 20)
        lib = cuda_ms(torch, lambda i: int_mm_dequant(
            torch, a, wq[:, :, 0, 0], sx * w_scale, torch.bfloat16), 20)
        plain = cuda_ms(torch, lambda i: quant.int8_gemm_plain(
            a, wq[:, :, 0, 0], sx * w_scale, torch.bfloat16), 3, warmup=1)
        q_ms = cuda_ms(torch, lambda i: quant.quantize_nhwc(xv, amax), 20)
        b_ms, b_by = bound_ms(m * k + n * k + m * n * 2, 2 * m * n * k,
                              INT8_OPS_PER_S)
        q_bound, _ = int8_quant_bound(xv)
        print(f"int8 GEMM {label} ({m}x{k} @ {k}x{n}): bit-exact (Q; I; "
              f"torch._int_mm agrees); I {ms:.4f} ms ({b_ms / ms:.0%} of the "
              f"bound), torch._int_mm + dequant {lib:.4f} ms ({ms / lib:.2f}"
              f"x), plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}); Q "
              f"{q_ms:.4f} ms, bound {q_bound:.4f} ms", flush=True)
    ms, plain, b_ms, b_by, lib, q_ms, q_plain, q_bound, q_lib = layer3
    # the library call computes Q's function only where its int8 values
    # equal Q's at every shape
    q_same = all(diff == 0 for *_, diff in q_libs)
    print("int8 Q against torch.quantize_per_tensor at the calibrated "
          "scale: " + ("bit-equal at every shape" if q_same else
                       "differs: " + json.dumps(
                           [[lab, b, d] for lab, b, _, d in q_libs
                            if d != 0])), flush=True)
    report["int8_conv"] = {
        "name": "int8_conv", "route": "cuda",
        "source": "halo_tpu_torch/csrc/int8_conv.cu",
        "replaces": "halo_tpu/ops/quant.py:81",
        "launches": 0, "max_abs_err": worst, "ms": ms, "plain_ms": plain,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}
    report["int8_quant"] = {
        "name": "int8_quant", "route": "cuda",
        "source": "halo_tpu_torch/csrc/int8_quant.cu",
        "replaces": "halo_tpu/ops/quant.py:68",
        "launches": 0, "max_abs_err": 0.0, "ms": q_ms, "plain_ms": q_plain,
        "bound_ms": q_bound, "bound_by": "bytes",
        "library_ms": q_lib if q_same else None}
    print("int8 Q with the prologue at R101 layer3's site, B 2, bf16: "
          + json.dumps(fused), flush=True)
    release(torch)


def stream_ms(torch, fn, calls: int = 50) -> float:
    """ms a call over ``calls`` calls of ``fn`` between one pair of CUDA
    events, queued behind a spin kernel of ~0.1 s so that the device runs
    them back to back: a kernel's time with its launch gap, without the
    cost of an event pair a call (``cuda_ms``)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # clock cycles
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def q_device_ms(torch, fn, iters: int = 10) -> float:
    """Kernel Q's device ms a call of ``fn`` (its kernels by name, launch
    gaps and events left out), from torch.profiler over ``iters`` calls
    (``profiled``); 0.0 when the trace holds none."""
    events, _ = profiled(torch, lambda: [fn() for _ in range(iters)])
    return sum(e.self_device_time_total for e in events
               if "quantize_" in e.key) / 1e3 / iters


def device_share(ms: float, bound: float) -> str:
    return (f"{ms:.4f} ms ({bound / ms:.0%} of the bound)" if ms > 0
            else "not measured")


def int8_fused_checks(torch, gen, amax) -> dict:
    """Phase int8 (1), kernel Q's prologue: at every fused site's shape
    (B = 2 and 4, bf16 and f32, channels-last) the kernel with a frozen
    norm's affine and the ReLU against its plain version and against the
    unfused ops (the norm module, torch.relu, Q alone), bit for bit, timed
    beside its bound and the yardstick (those unfused ops as the parent
    ran them); the ASPP bottleneck's five sources read in place against Q
    of their torch.cat (the parent's route); the edge cases; the NCHW tile
    path's time. Returns layer3's B = 2 bf16 numbers."""
    from halo_tpu_torch.ops import quant

    def channels_last(b, c, h, w, dtype):
        x = torch.randn((b, c, h, w), generator=gen, device=DEVICE) * 2
        return x.to(dtype).contiguous(memory_format=torch.channels_last)

    def check(sources, a, bn, label, relu=True):
        scale, shift = (bn.affine(sources[0].dtype) if bn is not None
                        else (None, None))
        got = quant.quantize_fused(sources, a, scale, shift, relu)
        want = quant.quantize_fused_plain(sources, a, scale, shift, relu)
        x = torch.cat(sources, dim=1) if len(sources) > 1 else sources[0]
        x = bn(x) if bn is not None else x
        unfused = quant.quantize_nhwc(torch.relu(x) if relu else x, a)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(got, unfused)):
            raise AssertionError(f"kernel Q's prologue off its plain version "
                                 f"or the unfused ops at {label}")
        return scale, shift

    layer3 = None
    for b in INT8_BATCHES:
        for dtype in (torch.bfloat16, torch.float32):
            for label, c, h, w in FUSED_SITES:
                x = channels_last(b, c, h, w, dtype)
                bn = frozen_bn(torch, gen, c)
                scale, shift = check([x], amax, bn, label)
                ms = cuda_ms(torch, lambda i: quant.quantize_fused(
                    (x,), amax, scale, shift, True), 20)
                alone = cuda_ms(torch, lambda i: quant.quantize_nhwc(
                    x, amax), 20)
                yard = cuda_ms(torch, lambda i: quant.quantize_nhwc(
                    torch.relu(bn(x)), amax), 20)
                dev = q_device_ms(torch, lambda: quant.quantize_fused(
                    (x,), amax, scale, shift, True))
                run = stream_ms(torch, lambda: quant.quantize_fused(
                    (x,), amax, scale, shift, True))
                bound, _ = int8_quant_bound(x, affine=True)
                name = "bf16" if dtype == torch.bfloat16 else "f32"
                print(f"int8 Q fused {label}, B {b}, {name}: ({b}, {c}, {h}, "
                      f"{w}) bit-exact (plain, unfused ops); {ms:.4f} ms, "
                      f"bound {bound:.4f} ms (bytes, {bound / ms:.0%}); "
                      f"back to back {run:.4f} ms; profiler device (the "
                      f"input in L2) {device_share(dev, bound)}; "
                      f"yardstick FrozenBatchNorm2d + torch.relu + Q "
                      f"{yard:.4f} ms ({yard / ms:.2f}x); Q alone "
                      f"{alone:.4f} ms", flush=True)
                if layer3 is None and "layer3" in label:
                    layer3 = {"ms": ms, "back_to_back_ms": run,
                              "device_ms": dev, "bound_ms": bound,
                              "yardstick_ms": yard, "alone_ms": alone}
                del x, bn, scale, shift
        release(torch)
    for b in INT8_BATCHES:
        pooled = torch.randn((b, 512, 1, 1), generator=gen, device=DEVICE)
        sources = [pooled.to(torch.bfloat16).expand(-1, -1, 80, 160)] + [
            channels_last(b, 512, 80, 160, torch.bfloat16) for _ in range(4)]
        check(sources, amax, None, f"the ASPP sources, B {b}", relu=False)
        ms = cuda_ms(torch, lambda i: quant.quantize_fused(sources, amax),
                     20)
        dev = q_device_ms(torch, lambda: quant.quantize_fused(sources, amax))
        run = stream_ms(torch, lambda: quant.quantize_fused(sources, amax))
        yard = cuda_ms(torch, lambda i: quant.quantize_nhwc(
            torch.cat(sources, dim=1), amax), 20)
        bound, _ = int8_quant_bound(sources)
        print(f"int8 Q on the ASPP bottleneck's five sources (the global "
              f"branch broadcast, four channels-last (B, 512, 80, 160)), B "
              f"{b}, bf16: bit-exact against Q of their torch.cat; {ms:.4f} "
              f"ms, bound {bound:.4f} ms (bytes, {bound / ms:.0%}); "
              f"back to back {run:.4f} ms; profiler device (the input in "
              f"L2) {device_share(dev, bound)}; "
              f"yardstick torch.cat + Q {yard:.4f} ms ({yard / ms:.2f}x)",
              flush=True)
        del sources, pooled
    release(torch)
    # edges: NaN, +-inf and -0; C = 40 and NCHW (the tile path); amax 0;
    # sources in several layouts, one of 24 channels; the ReLU alone
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn((2, 96, 13, 17), generator=gen, device=DEVICE) * 2
        flat = x.view(-1)
        idx = torch.randperm(flat.numel(), generator=gen, device=DEVICE)[:64]
        flat[idx] = torch.tensor([float("nan"), float("inf"), float("-inf"),
                                  -0.0] * 16, device=DEVICE)
        x = x.to(dtype)
        zero = torch.tensor(0.0, device=DEVICE)
        check([x.contiguous(memory_format=torch.channels_last)], amax,
              frozen_bn(torch, gen, 96), "NaN, +-inf, -0")
        check([x], amax, frozen_bn(torch, gen, 96), "NCHW")
        check([channels_last(2, 40, 13, 17, dtype)], amax,
              frozen_bn(torch, gen, 40), "C 40")
        check([channels_last(2, 96, 13, 17, dtype)], zero,
              frozen_bn(torch, gen, 96), "amax 0")
        check([channels_last(2, 96, 13, 17, dtype)], amax, None,
              "the ReLU alone")
        mixed = [torch.randn((2, 16, 1, 1), generator=gen, device=DEVICE)
                 .to(dtype).expand(-1, -1, 13, 17),
                 channels_last(2, 32, 13, 17, dtype),
                 torch.randn((2, 24, 13, 17), generator=gen,
                             device=DEVICE).to(dtype),
                 channels_last(2, 48, 13, 17, dtype)]
        check(mixed, amax, frozen_bn(torch, gen, 120), "mixed sources")
    print("int8 Q's prologue: bit-exact at the edge cases (NaN, +-inf, -0; "
          "NCHW and C 40 on the tile path; amax 0; the ReLU alone; four "
          "sources in three layouts, one broadcast, one of 24 channels), "
          "bf16 and f32", flush=True)
    x = torch.randn((2, 256, 80, 160), generator=gen, device=DEVICE).to(
        torch.bfloat16)
    bn = frozen_bn(torch, gen, 256)
    scale, shift = check([x], amax, bn, "NCHW layer3")
    ms = cuda_ms(torch, lambda i: quant.quantize_fused(
        (x,), amax, scale, shift, True), 20)
    bound, _ = int8_quant_bound(x, affine=True)
    print(f"int8 Q fused on an NCHW (2, 256, 80, 160) bf16 input (the tile "
          f"path, not the models' layout): bit-exact; {ms:.4f} ms, bound "
          f"{bound:.4f} ms (bytes, {bound / ms:.0%})", flush=True)
    release(torch)
    return layer3


def int8_layers(torch, model, shapes) -> int:
    """The quantised layers that run int8 in one forward of ``model``,
    given the input (H, W) each QuantConv saw (``shapes``): every
    QuantDense and every QuantConv but a strided one on a small grid
    (which runs float). Each launches kernels Q and I once."""
    from halo_tpu_torch.models.layers import QuantConv, QuantDense
    return sum(isinstance(mod, QuantDense) or (
        isinstance(mod, QuantConv) and not mod._small_strided(
            torch.empty((1, 1) + shapes[mod], device="meta")))
        for mod in model.modules())


def int8_fused_sites(torch, model, shapes) -> int:
    """The fused sites of ``model`` (a frozen norm and ReLU before a
    QuantConv) whose conv runs int8, given each QuantConv's input (H, W):
    kernel Q applies their norm and ReLU once a forward each."""
    from halo_tpu_torch.tools.int8_probe import site_pairs
    return sum(not conv._small_strided(torch.empty(
        (1, 1) + shapes[conv], device="meta"))
        for _, conv in site_pairs(model))


def forward_profile(torch, model, size=(640, 1280)) -> dict:
    """One eval forward of ``model`` (the flip pair as a batch of 2 at the
    test entry's input, bf16 autocast) under torch.profiler: its device
    kernels, copies, device ms, kernel Q's ms and torch.cat's count
    (``int8_probe.profile_forward``); the host ms of the call beside it."""
    from halo_tpu_torch.tools.int8_probe import profile_forward
    model.eval()     # the test entry leaves its model in train mode
    img = torch.randn((2, 3) + size, device=DEVICE)

    def forward():
        with torch.no_grad(), torch.autocast(DEVICE, dtype=torch.bfloat16):
            return model(img, size=size)

    forward()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    forward()
    host = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    line = profile_forward(model, forward, DEVICE == "cuda")
    line["host_ms"] = host
    return line


def phase_int8(torch, args, report):
    """int8 (W8A8) evaluation and the int8 sweep: (1) kernels Q and I
    against their plain versions; (2) the quantised R101 test entry on phase
    train's last.ckpt, then the float one; (3) the same for SegFormer-B4
    on phase acdc's last.ckpt; (4) the source_target recipe with
    TPU.QUANT_SWEEP, then a float round on the same weights. Launch
    counters are zeroed before each run and read at once after it."""
    from halo_tpu_torch import test as test_entry
    from halo_tpu_torch import train
    from halo_tpu_torch.active import cuda_radius, cuda_score, cuda_select
    from halo_tpu_torch.active.region_selection import region_selection
    from halo_tpu_torch.data import mask_cache
    from halo_tpu_torch.data.build import build_active_loader
    from halo_tpu_torch.data.catalog import DatasetCatalog
    from halo_tpu_torch.data.masks import load_indicator, load_mask_png
    from halo_tpu_torch.engine import learners
    from halo_tpu_torch.engine.state import load_state_dict_file
    from halo_tpu_torch.models import build_segmentor
    from halo_tpu_torch.models.layers import DilatedConv3x3, QuantConv
    from halo_tpu_torch.ops import dilated_conv as dc
    from halo_tpu_torch.ops import quant
    from halo_tpu_torch.ops.resize import resize_bilinear

    gen = torch.Generator(device=DEVICE).manual_seed(args.seed + 8)
    int8_kernel_checks(torch, gen, report)
    card = card_line()
    work = report["work"]

    int_mm = torch._int_mm
    int_mm_calls = [0]

    def counted_int_mm(*a, **k):
        int_mm_calls[0] += 1
        return int_mm(*a, **k)

    def counts():
        return {"int8_conv": quant.launches, "int8_quant":
                quant.quant_launches, "int8_quant_fused":
                quant.fused_launches, "int_mm": int_mm_calls[0],
                "layout_copies": quant.layout_copies,
                "fwd": dc.launches_fwd, "dx": dc.launches_dx,
                "dk": dc.launches_dk, "radius_map": cuda_radius.launches,
                "region_score": cuda_score.launches,
                "greedy_picks": cuda_select.launches}

    def zero_counts():
        quant.launches = quant.quant_launches = quant.layout_copies = 0
        quant.fused_launches = 0
        int_mm_calls[0] = 0
        dc.launches_fwd = dc.launches_dx = dc.launches_dk = 0
        dc.layout_copies = 0
        cuda_radius.launches = cuda_select.launches = 0
        cuda_score.launches = 0

    def expect(label, got, want):
        if got != want:
            raise AssertionError(f"{label}: launches {got}, want {want}")
        print(f"{label}: launches {got} (as the eligibility rule counts)",
              flush=True)

    def watch_shapes(model, shapes):
        """Record the input (H, W) of every QuantConv of ``model``."""
        for mod in model.modules():
            if isinstance(mod, QuantConv):
                mod.register_forward_pre_hook(lambda m, a: shapes.__setitem__(
                    m, tuple(first_source(a[0]).shape[-2:])))

    launches_total = quant_total = 0
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.ExitStack() as restore:
        # torch._int_mm counted while the int8 paths run: they call it 0
        # times
        torch._int_mm = counted_int_mm
        restore.callback(setattr, torch, "_int_mm", int_mm)
        root = Path(tmp)
        data = root / "datasets"
        t0 = time.perf_counter()
        write_gtav(data, 4, args.seed)
        write_cityscapes(data, args.images, args.seed)
        write_cityscapes(data, 2, args.seed + 1, split="val")
        write_acdc(data, args.seed)
        print(f"int8 setup (synthetic GTAV, Cityscapes and ACDC trees): "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        def test_run(label, recipe, name, ckpt, *extra):
            """The test entry with TEST.SAVE_EMBED over 2 val images:
            (result, launches, rich-eval ms a call, the first batch's
            outputs, the learner's model, its QuantConvs' input sizes)."""
            make_rich = learners.make_rich_eval_step
            kept, call_ms, models, shapes = [], [], [], {}

            def timed_rich(cfg, model):
                step = make_rich(cfg, model)
                models.append(model)
                watch_shapes(model, shapes)

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
                    ["-cfg", str(REPO / "configs" / recipe),
                     "MODEL.WEIGHTS", "", "resume", ckpt,
                     "TEST.SAVE_EMBED", "True", "TPU.DATASET_DIR", str(data),
                     "OUTPUT_DIR", str(root / "out"), "NAME", name,
                     "SEED", str(args.seed), *extra], device=DEVICE)
                torch.cuda.synchronize()
            finally:
                learners.make_rich_eval_step = make_rich
            wall = time.perf_counter() - t0
            got = counts()
            if len(call_ms) != 2 or not math.isfinite(result["mIoU"]):
                raise AssertionError(f"{label}: {result}, {len(call_ms)} "
                                     "batches")
            print(f"{label}: mIoU {result['mIoU']:.4f} over 2 images; rich "
                  f"eval ms/img {json.dumps([round(v, 2) for v in call_ms])}"
                  f" (entry {wall:.1f} s with model build, resume and "
                  f"calibration); peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
                  f"{card}", flush=True)
            return result, got, call_ms, kept[0], models[0], shapes

        def same_preds(name_a, name_b):
            """Share of pixels predicted alike by two test entries."""
            same = total = 0
            for path in sorted((root / "out" / name_a / "embed")
                               .glob("*.pt")):
                a = torch.load(path, weights_only=False)["pred"]
                b = torch.load(root / "out" / name_b / "embed" / path.name,
                               weights_only=False)["pred"]
                same += int((a == b).sum())
                total += a.numel()
            return same / max(total, 1)

        def hold_rich_radius(label, r):
            """The rich radius map against the plain dist0 of the same
            embedding (t = tanh(r/2) near the ball's edge)."""
            size = tuple(r["radius"].shape[1:3])
            plain = resize_bilinear(cuda_radius.radius_map_reference(
                r["embed"])[..., None], size)[..., 0]
            t_diff = float((torch.tanh(r["radius"] / 2)
                            - torch.tanh(plain / 2)).abs().max())
            inner = torch.tanh(plain / 2) < 0.9
            rel = (max_rel(torch, r["radius"][inner], plain[inner])
                   if bool(inner.any()) else 0.0)
            if rel > 1e-6 or t_diff > 1e-6:
                raise AssertionError(f"{label}: rich radius off the plain "
                                     f"dist0: rel {rel}, |t| {t_diff}")
            print(f"{label}: rich radius map {tuple(r['radius'].shape)} vs "
                  f"plain dist0: max rel diff {rel:.3e} where t < 0.9, max "
                  f"|t| diff {t_diff:.3e}", flush=True)

        for part, recipe, name, ckpt in (
                ("(2) R101", "gtav/test.yaml", "r101",
                 work / "r101_last.ckpt"),
                ("(3) SegFormer-B4", "acdc/test.yaml", "mitb4",
                 work / "mitb4_last.ckpt")):
            result, got, call_ms, r, model, shapes = test_run(
                f"{part} int8 test", recipe, name + "_int8", str(ckpt),
                "TPU.QUANT_EVAL", "True")
            quant.assert_calibrated(model)
            layers = int8_layers(torch, model, shapes)
            sites = int8_fused_sites(torch, model, shapes)
            n_conv_c = sum(isinstance(m, DilatedConv3x3)
                           for m in model.modules())
            expect(f"{part} int8 test", got, {
                "int8_conv": 2 * layers, "int8_quant": 2 * layers,
                "int8_quant_fused": 2 * sites,
                "int_mm": 0, "layout_copies": 0, "fwd": 0, "dx": 0,
                "dk": 0, "radius_map": 2, "region_score": 0,
                "greedy_picks": 0})
            if layers <= 0 or n_conv_c:
                raise AssertionError(f"{part}: {layers} int8 layers, "
                                     f"{n_conv_c} kernel-C convs")
            print(f"{part} int8 model: {layers} quantised layers a forward "
                  "(one forward an image: the flip pair), each kernel Q "
                  f"then kernel I: 2 launches a layer; {sites} of the Q "
                  "launches apply their producer's frozen norm and ReLU; "
                  "torch._int_mm 0, layout copies 0", flush=True)
            launches_total += got["int8_conv"]
            quant_total += got["int8_quant"]
            hold_rich_radius(f"{part} int8 test", r)
            prof = forward_profile(torch, model)
            del r, model, shapes
            release(torch)
            float_result, _, float_ms, _, fmodel, _ = test_run(
                f"{part} float test (same checkpoint)", recipe,
                name + "_float", str(ckpt))
            fprof = forward_profile(torch, fmodel)
            del fmodel
            # the ASPP concatenation is read in place by kernel Q: the int8
            # forward makes one torch.cat fewer than the float one
            if sites and prof["cats"] != fprof["cats"] - 1:
                raise AssertionError(f"{part}: torch.cat {prof['cats']} "
                                     f"times (float {fprof['cats']})")
            print(f"{part} a forward under the profiler (B 2 at 640x1280, "
                  f"bf16), int8 / float: device kernels {prof['kernels']} / "
                  f"{fprof['kernels']}, copies {prof['copies']} / "
                  f"{fprof['copies']}, device ms {prof['device_ms']:.3f} / "
                  f"{fprof['device_ms']:.3f}, host ms {prof['host_ms']:.2f}"
                  f" / {fprof['host_ms']:.2f}; kernel Q "
                  f"{prof['q_ms']:.3f} device ms; torch.cat "
                  f"{prof['cats']} / {fprof['cats']}; counters "
                  + json.dumps(prof["counters"]), flush=True)
            print(f"{part}: int8 mIoU {result['mIoU']:.4f} against float "
                  f"{float_result['mIoU']:.4f}; second image "
                  f"{call_ms[1]:.2f} ms/img against float "
                  f"{float_ms[1]:.2f}; "
                  f"{same_preds(name + '_int8', name + '_float'):.4f} of "
                  "the pixels predicted alike", flush=True)
            release(torch)

        # (4) the int8 sweep: round 1 at step 0 through train.main, the
        # region_selection call wrapped to time its stages and keep stats
        steps = 2
        rounds = []

        def timed_round(cfg, model, loader, round_number, **kwargs):
            stages = {}
            stats = region_selection(cfg, model, loader, round_number,
                                     stage_seconds=stages, **kwargs)
            rounds.append((model, stats, stages))
            return stats

        # the recipe's rounds (the first at step 0, 1% of the budget)
        argv = ["-cfg", str(CONFIG), "TPU.DENSE_CONV_MODE", "pallas",
                "TPU.QUANT_SWEEP", "True", "MODEL.WEIGHTS", "",
                "resume", "", "SOLVER.NUM_ITER", str(steps),
                "TPU.VAL_INTERVAL", "0",
                "TPU.DATASET_DIR", str(data), "OUTPUT_DIR", str(root / "out"),
                "NAME", "sweep_int8", "SEED", str(args.seed)]
        shapes, run_stages = {}, {}
        mask_cache.clear()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        learners.region_selection = timed_round
        t0 = time.perf_counter()
        try:
            learner = train.main(argv, device=DEVICE,
                                 stage_seconds=run_stages)
            torch.cuda.synchronize()
        finally:
            learners.region_selection = region_selection
        wall = time.perf_counter() - t0
        got = counts()
        twin = learner.quant_twin
        (sweep_model, stats, stages), = rounds
        cfg = learner.cfg
        n = stats["images"]
        picks = math.ceil(1024 * 2048 * cfg.ACTIVE.BUDGET
                          / len(cfg.ACTIVE.SELECT_ITER) / 9)
        if sweep_model is not twin or n != args.images or \
                stats["picked"] != n * picks:
            raise AssertionError(f"(4) int8 round: {stats}, want {n} x "
                                 f"{picks} picks from the int8 twin")
        quant.assert_calibrated(twin)
        amax = [float(m.amax) for _, m in quant.quant_layers(twin)]
        if quant.quant_layers(learner.model):
            raise AssertionError("(4) the training model is quantised")
        for entry in learner.active_loader.dataset.data_list:
            mask = load_mask_png(entry["label_mask"])
            ind = load_indicator(entry["indicator"])
            if (mask.shape != (1024, 2048)
                    or (ind["selected"] & ~ind["active"]).any()
                    or ((mask != 255) & ~ind["selected"]).any()
                    or not (mask != 255).any()):
                raise AssertionError(f"(4) bad mask/indicator for "
                                     f"{entry['name']}")
        watch_shapes(twin, shapes)
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            w_in, h_in = cfg.INPUT.INPUT_SIZE_TEST
            twin(torch.zeros((1, 3, h_in, w_in), device=DEVICE))
        layers = int8_layers(torch, twin, shapes)
        sites = int8_fused_sites(torch, twin, shapes)
        batches = math.ceil(n / int(cfg.TPU.ACTIVE_BATCH))
        n_conv_c = sum(isinstance(m, DilatedConv3x3)
                       for m in learner.model.modules())
        expect("(4) int8 sweep", got, {
            "int8_conv": batches * layers, "int8_quant": batches * layers,
            "int8_quant_fused": batches * sites,
            "int_mm": 0, "layout_copies": 0,
            "fwd": 2 * n_conv_c * steps, "dx": 2 * n_conv_c * steps,
            "dk": 2 * n_conv_c * steps, "radius_map": 0, "region_score": n,
            "greedy_picks": batches})
        launches_total += got["int8_conv"]
        quant_total += got["int8_quant"]
        per_img = {k: v / n * 1e3 for k, v in sorted(stages.items())}
        print(f"(4) int8 sweep: {stats}; {n} masks and indicators written "
              f"and consistent; twin amax all > 0 (min {min(amax):.4g} over "
              f"{len(amax)} layers); score kernels {got['region_score']} "
              "pairs; round stages "
              "ms/img " + json.dumps({k: round(v, 3) for k, v in
                                      per_img.items()})
              + f" ({sum(per_img.values()):.1f} in all); the learner's "
              f"round stage (checkpoint, twin calibration, sweep) "
              f"{run_stages['round'] * 1e3 / n:.1f} ms/img; run {wall:.1f} "
              f"s; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
              f"{card}", flush=True)
        # the float round on the same weights, into its own mask store
        fcfg = cfg.clone()
        fcfg.defrost()
        fcfg.SAVE_DIR = str(root / "out" / "sweep_float")
        fmodel = build_segmentor(fcfg, device=DEVICE)
        fmodel.load_state_dict(load_state_dict_file(
            str(Path(cfg.SAVE_DIR) / "model_before_round_1.ckpt")),
            strict=True)
        DatasetCatalog.init_mask(fcfg)
        mask_cache.clear()
        fstages = {}
        fstats = region_selection(fcfg, fmodel, build_active_loader(fcfg), 1,
                                  device=DEVICE, stage_seconds=fstages)
        torch.cuda.synchronize()
        shared = labelled = 0
        for entry, fentry in zip(
                learner.active_loader.dataset.data_list,
                build_active_loader(fcfg).dataset.data_list):
            a = load_mask_png(entry["label_mask"]) != 255
            b = load_mask_png(fentry["label_mask"]) != 255
            shared += int((a & b).sum())
            labelled += int(b.sum())
        fper = {k: v / n * 1e3 for k, v in sorted(fstages.items())}
        print(f"(4) float round on the same weights: {fstats}; stages "
              "ms/img " + json.dumps({k: round(v, 3) for k, v in
                                      fper.items()})
              + f" ({sum(fper.values()):.1f} in all); int8 / float forward "
              f"{per_img['forward'] / fper['forward']:.3f}; "
              f"{shared / max(labelled, 1):.4f} of the float round's "
              "labelled pixels labelled by the int8 round too", flush=True)
        del learner, twin, fmodel, sweep_model, rounds
        release(torch)
    report["int8_conv"]["launches"] = launches_total
    report["int8_quant"]["launches"] = quant_total


# ---------------------------------------------------------------------------
# Phase parallel: data parallelism over torch.distributed
# ---------------------------------------------------------------------------

PARALLEL_STEPS = 3  # phase parallel: train steps of each run
PARALLEL_TIMEOUT = 420  # s, each run of phase parallel (its processes)
# the command of a phase-parallel process
CHILD = [sys.executable, str(REPO / "chip_smoke.py"), "--parallel-child"]


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def param_digest(model) -> str:
    """sha256 of the model's parameters' bytes, in order."""
    import hashlib
    digest = hashlib.sha256()
    for p in model.parameters():
        digest.update(p.detach().float().cpu().numpy().tobytes())
    return digest.hexdigest()


def spatial_check(torch, seed: int) -> dict:
    """Phase parallel (c), on each rank of the group: the rank's 512 rows
    of a 1024x2048 map (19 classes, a 64-wide ball embedding, kernel B on
    its rows) through ``spatial_region_score``, held against
    ``floating_region_score`` of the whole map within 1e-6, for both
    purity pairs of ``tests/test_parallel.py``; ms of each."""
    import torch.distributed as dist
    from halo_tpu_torch.active import cuda_radius
    from halo_tpu_torch.active.scoring import (floating_region_score,
                                               spatial_region_score)
    rank, n = dist.get_rank(), dist.get_world_size()
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    h, w = 1024, 2048
    logits = torch.randn((h, w, 19), generator=gen, device=DEVICE) * 3.0
    embed = ball_points(torch, (h, w, 64), gen).float()
    rows = slice(rank * h // n, (rank + 1) * h // n)
    mine = (logits[rows].contiguous(), embed[rows].contiguous())
    out = {}
    for pur, unc in (("radius", "entropy"), ("ripu", "pixel_entropy")):
        opts = dict(unc_type=unc, pur_type=pur, size=3, num_classes=19,
                    normalize=True)
        before = cuda_radius.launches
        got = spatial_region_score(*mine, group=dist.group.WORLD, **opts)
        launches = cuda_radius.launches - before
        want = floating_region_score(logits, embed, **opts)
        err = max(float((g - x[rows]).abs().max()) for g, x in zip(got, want))

        def timed(fn):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(5):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 5

        out[pur] = {"max_abs_err": err, "radius_launches": launches,
                    "rows": got[0].shape[0],
                    "ms": timed(lambda: spatial_region_score(
                        *mine, group=dist.group.WORLD, **opts)),
                    "whole_ms": timed(lambda: floating_region_score(
                        logits, embed, **opts))}
    return out


def parallel_child(spec_path: str) -> int:
    """One run of phase parallel in a process of its own: ``train.main``
    with or without a process group (joined here from the torchrun
    variables the parent set, with the spec's device and backend); the
    launch counts of the run, its losses, checkpoints written and a digest
    of the parameters; ms/step on one device-resident batch between CUDA
    events and by ``StepTimer``; with a group of 2, phase parallel (c).
    Writes its results as JSON to the spec's 'out'."""
    import statistics

    import torch
    spec = json.loads(Path(spec_path).read_text())
    sys.path.insert(0, str(REPO))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from halo_tpu_torch import kernels, train
    from halo_tpu_torch.active import cuda_radius, cuda_score, cuda_select
    from halo_tpu_torch.engine import learners
    from halo_tpu_torch.ops import dilated_conv as dc
    from halo_tpu_torch.parallel import mesh
    from halo_tpu_torch.utils.profiling import StepTimer

    if DEVICE == "cuda":
        kernels.load()
    # the same dropout draws in every run (torch seeds each process's
    # generators at random); rank r > 0 then offsets them by r
    torch.manual_seed(spec["seed"])
    saved = []
    save = learners.save_checkpoint

    def record(model, path, **kwargs):
        saved.append(Path(path).name)
        return save(model, path, **kwargs)

    learners.save_checkpoint = record
    device = spec["device"]
    if spec["group"]:
        device = mesh.init_from_env(device, spec["backend"])
    try:
        dc.launches_fwd = dc.launches_dx = dc.launches_dk = 0
        cuda_radius.launches = cuda_select.launches = 0
        cuda_score.launches = 0
        stages = {}
        learner = train.main(spec["argv"], device=device,
                             stage_seconds=stages, backend=spec["backend"])
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        out = {"launches": {"fwd": dc.launches_fwd, "dx": dc.launches_dx,
                            "dk": dc.launches_dk,
                            "radius_map": cuda_radius.launches,
                            "region_score": cuda_score.launches,
                            "greedy_picks": cuda_select.launches},
               "history": learner.history, "saved": list(saved),
               "best_miou": learner.best_miou,
               "params": param_digest(learner.model),
               "step_ms": [(a + b) * 1e3 for a, b in learner.step_seconds],
               "stages": stages, "num_devices": learner.num_devices}
        batches = fixed_batches(learner)
        out["fixed_ms"] = fixed_batch_ms(torch, learner, batches)
        timer = StepTimer()
        for _ in range(3):
            timer.start()
            timer.stop(block_on=learner.train_step(batches))
        out["step_timer_ms"] = timer.avg_s * 1e3
        out["fixed_median_ms"] = statistics.median(out["fixed_ms"])
        del batches, learner
        if spec.get("spatial") is not None:
            out["spatial"] = spatial_check(torch, spec["spatial"])
    finally:
        if spec["group"]:
            mesh.destroy()
    Path(spec["out"]).write_text(json.dumps(out))
    return 0


def run_children(root: Path, name: str, specs: list) -> list:
    """Start one process a spec (each with its torchrun variables, or none),
    join them within ``PARALLEL_TIMEOUT``; a process that times out is
    killed and fails the phase, as does one that exits non-zero. Returns
    their results."""
    import os
    from halo_tpu_torch.parallel.launch import TORCHRUN_VARS, run_processes
    port = free_port()
    commands, envs = [], []
    for i, spec in enumerate(specs):
        spec["out"] = str(root / f"{name}_{i}.json")
        path = root / f"{name}_{i}.spec.json"
        path.write_text(json.dumps(spec))
        env = {k: v for k, v in os.environ.items()
               if k not in TORCHRUN_VARS}
        if spec["group"]:
            env.update(RANK=str(spec["rank"]), WORLD_SIZE=str(spec["world"]),
                       LOCAL_RANK=str(spec["rank"]), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port))
        commands.append(CHILD + [str(path)])
        envs.append(env)
    try:
        run_processes(commands, envs, [str(root / f"{name}_{i}.log")
                                       for i in range(len(specs))],
                      PARALLEL_TIMEOUT, cwd=str(REPO))
    except RuntimeError as e:
        raise AssertionError(f"parallel {name}: {e}") from None
    return [json.loads(Path(s["out"]).read_text()) for s in specs]


def mask_bytes(save_dir: Path) -> dict:
    """{relative path: bytes} of a run's mask PNGs and of its indicators'
    bool maps."""
    from halo_tpu_torch.data.masks import load_indicator
    out = {}
    for path in sorted((save_dir / "gtMask").rglob("*.png")):
        out[str(path.relative_to(save_dir))] = path.read_bytes()
    for path in sorted((save_dir / "gtIndicator").rglob("*.pth")):
        ind = load_indicator(str(path))
        out[str(path.relative_to(save_dir))] = b"".join(
            ind[k].tobytes() for k in sorted(ind))
    return out


def phase_parallel(torch, args, report):
    """Data parallelism over torch.distributed at the recipe's full width
    (configs/gtav/source_target.yaml, TPU.DENSE_CONV_MODE pallas, round 1
    at step 0 over the 8 synthetic 1024x2048 images, 3 steps, validation on
    2 images), each run a process of its own: (a) one rank over NCCL
    beside the same run with no group; (b) two ranks sharing the one card
    over gloo; (c) spatial_region_score over (b)'s two ranks."""
    import statistics

    from halo_tpu_torch.engine.state import load_state_dict_file
    from halo_tpu_torch.models import build_segmentor
    from halo_tpu_torch.utils.misc import parse_args

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        data = root / "datasets"
        write_gtav(data, 4, args.seed)
        write_cityscapes(data, args.images, args.seed)
        write_cityscapes(data, 2, args.seed + 1, split="val")

        def argv(name, world):
            return ["-cfg", str(CONFIG), "TPU.DENSE_CONV_MODE", "pallas",
                    "MODEL.WEIGHTS", "", "resume", "",
                    "ACTIVE.SELECT_ITER", "[0]",
                    "SOLVER.NUM_ITER", str(PARALLEL_STEPS * world),
                    "TPU.VAL_INTERVAL", str(PARALLEL_STEPS),
                    "TPU.DATASET_DIR", str(data), "OUTPUT_DIR", str(root),
                    "NAME", name, "SEED", str(args.seed)]

        # (a) one rank over NCCL, beside the same run with no group
        plain, = run_children(root, "a_plain", [
            {"group": False, "device": DEVICE, "backend": None,
             "argv": argv("a_plain", 1), "seed": args.seed}])
        one, = run_children(root, "a_nccl", [
            {"group": True, "rank": 0, "world": 1, "device": None,
             "backend": None, "argv": argv("a_nccl", 1),
             "seed": args.seed}])
        if mask_bytes(root / "a_plain") != mask_bytes(root / "a_nccl") \
                or not mask_bytes(root / "a_plain"):
            raise AssertionError("(a): the one-rank group's masks differ "
                                 "from the run's without a group")
        worst = 0.0
        for got, want in zip(one["history"], plain["history"]):
            for k, v in want.items():
                if k.startswith(("loss", "negative", "consistency")):
                    worst = max(worst, abs(got[k] - v) / abs(v))
        if (len(one["history"]) != PARALLEL_STEPS or worst > 1e-5
                or one["launches"] != plain["launches"]
                or one["num_devices"] != 1):
            raise AssertionError(f"(a): losses {one['history']} against "
                                 f"{plain['history']} (worst rel {worst}); "
                                 f"launches {one['launches']} against "
                                 f"{plain['launches']}")
        n_conv = 25
        want = {"fwd": n_conv * (2 * PARALLEL_STEPS + 2 + 2),
                "dx": 2 * n_conv * PARALLEL_STEPS,
                "dk": 2 * n_conv * PARALLEL_STEPS, "radius_map": 0,
                "region_score": 8, "greedy_picks": 2}
        if one["launches"] != want:
            raise AssertionError(f"(a): launches {one['launches']}, want "
                                 f"{want}")
        print(f"parallel (a): one rank over NCCL against no group: masks "
              f"byte-identical, losses within {worst:.2e} relative, "
              f"launches {one['launches']} in both; ms/step on a fixed "
              f"device-resident batch (CUDA events, median of 5): no group "
              f"{plain['fixed_median_ms']:.2f}, NCCL group of one "
              f"{one['fixed_median_ms']:.2f} (the collectives and the "
              f"synced BN on one card, across processes: "
              f"{one['fixed_median_ms'] - plain['fixed_median_ms']:+.2f}); "
              f"StepTimer {plain['step_timer_ms']:.2f} / "
              f"{one['step_timer_ms']:.2f}; {card_line()}", flush=True)

        # (b) two ranks sharing the card over gloo, SOLVER.BATCH_SIZE 2
        # each; (c) spatial_region_score over the same two ranks
        ranks = run_children(root, "b_gloo", [
            {"group": True, "rank": r, "world": 2, "device": f"{DEVICE}:0",
             "backend": "gloo", "argv": argv("b_gloo", 2),
             "seed": args.seed, "spatial": args.seed} for r in range(2)])
        for r, out in enumerate(ranks):
            counts = out["launches"]
            if (counts["greedy_picks"] != 1 or counts["radius_map"] != 0
                    or counts["region_score"] != 4
                    or counts["dx"] != 2 * n_conv * PARALLEL_STEPS
                    or counts["fwd"] != n_conv * (2 * PARALLEL_STEPS + 2)
                    or out["num_devices"] != 2):
                raise AssertionError(f"(b) rank {r}: launches {counts}")
        if mask_bytes(root / "b_gloo") != mask_bytes(root / "a_nccl"):
            raise AssertionError("(b): the two ranks' masks differ from "
                                 "(a)'s")
        if ranks[0]["params"] != ranks[1]["params"]:
            raise AssertionError("(b): the ranks' parameters differ")
        if ranks[0]["best_miou"] != ranks[1]["best_miou"]:
            raise AssertionError(f"(b): mIoU {ranks[0]['best_miou']} / "
                                 f"{ranks[1]['best_miou']}")
        if ranks[0]["history"] != ranks[1]["history"]:
            raise AssertionError("(b): the ranks logged other losses")
        if ranks[1]["saved"] or ranks[0]["saved"] != [
                "model_before_round_1.ckpt", "best_mIoU.ckpt", "last.ckpt"]:
            raise AssertionError(f"(b): checkpoints written: rank 0 "
                                 f"{ranks[0]['saved']}, rank 1 "
                                 f"{ranks[1]['saved']}")
        lines = (root / "b_gloo" / "metrics.jsonl").read_text().splitlines()
        recs = [json.loads(line) for line in lines]
        if ([r["step"] for r in recs if "step" in r]
                != list(range(PARALLEL_STEPS))
                or sum("mIoU" in r for r in recs) != 1):
            raise AssertionError(f"(b): metrics.jsonl {recs}")
        _, cfg = parse_args(argv("b_gloo", 2))
        model = build_segmentor(cfg, device=DEVICE)
        model.load_state_dict(load_state_dict_file(
            str(root / "b_gloo" / "last.ckpt")), strict=True)
        if param_digest(model) != ranks[0]["params"]:
            raise AssertionError("(b): last.ckpt does not hold the ranks' "
                                 "parameters")
        del model
        release(torch)
        print(f"parallel (b): two ranks over gloo, 4 images each scored "
              f"(A {ranks[0]['launches']['greedy_picks']}, B "
              f"{ranks[0]['launches']['radius_map']} a rank), masks "
              f"byte-identical with (a)'s; parameters identical after "
              f"{PARALLEL_STEPS} steps (sha256 {ranks[0]['params'][:16]}); "
              f"mIoU {ranks[0]['best_miou']:.4f} on both; checkpoints and "
              f"metrics.jsonl by rank 0 alone; last.ckpt loads with "
              f"strict=True into a one-process model", flush=True)
        for r, out in enumerate(ranks):
            print(f"parallel (b) rank {r} of two processes sharing one card "
                  f"(not a scaling figure): ms/step on a fixed batch, CUDA "
                  f"events, median {out['fixed_median_ms']:.2f} of "
                  + json.dumps([round(t, 2) for t in out["fixed_ms"]])
                  + f"; StepTimer {out['step_timer_ms']:.2f}; wall ms/step "
                  + json.dumps([round(t, 1) for t in out["step_ms"]])
                  + f"; launches {out['launches']}", flush=True)
        for pur in ("radius", "ripu"):
            errs = [out["spatial"][pur]["max_abs_err"] for out in ranks]
            b = [out["spatial"][pur]["radius_launches"] for out in ranks]
            rows = [out["spatial"][pur]["rows"] for out in ranks]
            if max(errs) > 1e-6 or rows != [512, 512] or b != (
                    [1, 1] if pur == "radius" else [0, 0]):
                raise AssertionError(f"(c) {pur}: errors {errs}, rows "
                                     f"{rows}, kernel B {b}")
            print(f"parallel (c) spatial_region_score {pur}: 512 rows a "
                  f"rank, max |diff| to the whole map "
                  f"{max(errs):.3e}; kernel B launches {b}; ms "
                  + json.dumps([round(out["spatial"][pur]["ms"], 3)
                                for out in ranks])
                  + " against the whole map on each rank "
                  + json.dumps([round(out["spatial"][pur]["whole_ms"], 3)
                                for out in ranks])
                  + f" (two processes sharing one card); {card_line()}",
                  flush=True)
        # this phase's launches join the kernels line
        for out in [one] + ranks:
            counts = out["launches"]
            report["greedy_picks"]["launches"] += counts["greedy_picks"]
            report["radius_map"]["launches"] += counts["radius_map"]
            report["region_score"]["launches"] += counts["region_score"]
            report["dilated_conv3x3"]["launches"] += (counts["fwd"]
                                                      + counts["dx"])
            report["dilated_conv3x3_wgrad"]["launches"] += counts["dk"]
        print("parallel: phase time in the processes, s: " + json.dumps(
            {k: round(v, 2) for k, v in ranks[0]["stages"].items()}),
            flush=True)


QUALITY_AB = {"seeds": 1, "steps": 48, "pretrain_steps": 400,
              "budget": 0.04}  # phase quality (a): the JAX harness's recipe


def lightning_checkpoint(torch, cfg, path: Path, seed: int):
    """A reference-format Lightning checkpoint of a seeded model of
    ``cfg``: ``{"state_dict", "epoch", "global_step"}`` with the keys under
    ``feature_extractor.backbone.`` and ``classifier.``."""
    from halo_tpu_torch.models import build_segmentor

    model = build_segmentor(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(seed))
    sd = model.state_dict()
    if not all(k.startswith(("feature_extractor.backbone.", "classifier."))
               for k in sd):
        raise AssertionError("the model's keys leave the reference layout")
    torch.save({"state_dict": sd, "epoch": 1, "global_step": 60000}, path)
    return len(sd)


def captured(fn, *a, **k) -> tuple:
    """(fn's return value, what it printed), printed as well."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **k)
    print(buf.getvalue(), end="", flush=True)
    return out, buf.getvalue()


QUALITY_MAP = (96, 128)  # (a), (b): the shift set's native (H, W)
QUALITY_EMBED = 16  # (a), (b): the embedding width (REDUCED_CHANNELS 16)
# (a): picks a map and round (the budget over two rounds, 3x3 regions)
QUALITY_PICKS = math.ceil(QUALITY_MAP[0] * QUALITY_MAP[1]
                          * QUALITY_AB["budget"] / 2 / 9)


def quality_kernel_checks(torch, gen, report):
    """Kernels A, B and C against their plain versions at the shapes phase
    quality gives them, before its parts run (these launches are not the
    parts'): C forward, dx and dk at resnettiny's one kernel-C conv,
    layer4's conv2 (512 channels, d = 2, a 12x16 map at 96x128) in the
    A/B's train step (B = 2) and round (B = 4), with phase conv's
    tolerance; the score kernels at the round's shapes (96x128 logits of 19
    classes and a 12x16x16 embedding to the native 96x128, bf16) within
    1e-5 of their plain version; B within 1e-6 relative on the probe's
    float32 (96, 128, 16) map and the quickstart's float32
    (256, 512, 64) map; A bit for bit on a round's stack of four 96x128
    maps (28 picks, m = 5: ties, a labelled block, one that stops early)
    and on the quickstart's 256x512 map (100 picks)."""
    from halo_tpu_torch.active import cuda_radius, cuda_score, cuda_select
    from halo_tpu_torch.ops import dilated_conv as dc

    h, w = QUALITY_MAP
    errs = {"fwd": 0.0, "dx": 0.0, "dk": 0.0}
    for b in (2, 4):
        def operand(c):
            t = torch.randn((b, c, h // 8, w // 8), generator=gen,
                            device=DEVICE)
            return t.to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last)
        wt = (torch.randn((512, 512, 3, 3), generator=gen, device=DEVICE)
              / math.sqrt(9 * 512)).to(torch.bfloat16).contiguous(
                  memory_format=torch.channels_last)
        got = check_conv(torch, dc, operand(512), wt, operand(512), 2,
                         f"resnettiny layer4 512ch d=2 B={b} 12x16 bf16")
        errs = {k: max(v, got[k]) for k, v in errs.items()}

    lg = torch.randn((h, w, 19), generator=gen, device=DEVICE) * 3.0
    em = ball_points(torch, (h // 8, w // 8, QUALITY_EMBED), gen,
                     dtype=torch.float32)
    got = cuda_score.region_score(lg, em, (h, w))
    want = cuda_score.region_score_plain(lg, em, (h, w))
    torch.cuda.synchronize()
    worst_s = max(float((a - b).abs().max()) for a, b in zip(got, want))
    print(f"quality score kernels, the A/B round's {h}x{w} map: score, "
          f"impurity, uncertainty max abs diff {worst_s:.3e}", flush=True)
    if worst_s > 1e-5:
        raise AssertionError(f"the score kernels off their plain version "
                             f"at the A/B round's shapes: {worst_s}")
    worst_b = 0.0
    for label, x in (
            ("radius probe f32", ball_points(
                torch, (h, w, QUALITY_EMBED), gen).float()),
            ("quickstart f32", ball_points(
                torch, (256, 512, 64), gen).float())):
        got = cuda_radius.radius_map(x)
        want = cuda_radius.radius_map_reference(x)
        torch.cuda.synchronize()
        rel = max_rel(torch, got, want)
        worst_b = max(worst_b, float((got - want).abs().max()))
        print(f"quality radius {label} {tuple(x.shape)}: max rel diff "
              f"{rel:.3e}", flush=True)
        if rel > 1e-6:
            raise AssertionError(f"kernel B off its plain version on the "
                                 f"{label}: {rel}")

    kw = dict(num_picks=QUALITY_PICKS, mask_radius=5)
    ties = torch.randn((h, w), generator=gen, device=DEVICE)
    labelled = torch.randn((h, w), generator=gen, device=DEVICE)
    labelled[20:50, 30:90] = float("-inf")
    sparse = torch.full((h, w), float("-inf"), device=DEVICE)
    idx = torch.randint(0, h * w, (12,), generator=gen, device=DEVICE)
    sparse.view(-1)[idx] = torch.rand((12,), generator=gen, device=DEVICE)
    maps = torch.stack([torch.randn((h, w), generator=gen, device=DEVICE),
                        ties.to(torch.bfloat16).float(), labelled, sparse])
    picks, counts = cuda_select.greedy_picks(maps, **kw)
    for i in range(4):
        same_picks(torch, (picks[i], counts[i]),
                   cuda_select.greedy_picks_reference(maps[i], **kw),
                   f"A/B round's map {i}")
    one = torch.randn((256, 512), generator=gen, device=DEVICE)
    kw = dict(num_picks=100, mask_radius=5)
    same_picks(torch, cuda_select.greedy_picks(one, **kw),
               cuda_select.greedy_picks_reference(one, **kw),
               "quickstart's map")
    print(f"quality select: bit-exact on a stack of four 96x128 maps "
          f"({counts.tolist()} of {QUALITY_PICKS} picks) and on a 256x512 "
          f"map (100 picks)", flush=True)
    for name, err in (("dilated_conv3x3", max(errs["fwd"], errs["dx"])),
                      ("dilated_conv3x3_wgrad", errs["dk"]),
                      ("radius_map", worst_b), ("region_score", worst_s)):
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)


def phase_quality(torch, args, report):
    """The user tools at full recipe or full width: (a) the
    acquisition-quality A/B, (b) the radius-rarity probe on (a)'s pretrain,
    (c) the mIoU-parity command on a seeded R101 Lightning checkpoint, (d)
    the quickstart. Launch counters are zeroed before each part and read
    at once after it; the phase's launches join the kernels line."""
    from halo_tpu_torch.active import cuda_radius, cuda_score, cuda_select
    from halo_tpu_torch.ops import dilated_conv as dc
    from halo_tpu_torch.tools import (acquisition_quality, quickstart,
                                      radius_rarity, verify_parity)
    from halo_tpu_torch.utils.misc import parse_args

    card = card_line()

    def counts():
        return {"greedy_picks": cuda_select.launches,
                "radius_map": cuda_radius.launches,
                "region_score": cuda_score.launches, "fwd": dc.launches_fwd,
                "dx": dc.launches_dx, "dk": dc.launches_dk}

    def zero_counts():
        dc.launches_fwd = dc.launches_dx = dc.launches_dk = 0
        cuda_radius.launches = cuda_select.launches = 0
        cuda_score.launches = 0

    phase = {k: 0 for k in counts()}
    seconds = {}

    def read(part, t0):
        torch.cuda.synchronize()
        seconds[part] = time.perf_counter() - t0
        got = counts()
        for k, v in got.items():
            phase[k] += v
        return got

    quality_kernel_checks(torch, torch.Generator(device=DEVICE).manual_seed(
        args.seed + 11), report)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        work = root / "ab"

        # (a) the A/B: the JAX harness's recipe, unchanged
        zero_counts()
        t0 = time.perf_counter()
        out = acquisition_quality.main(device=DEVICE, workdir=str(work),
                                       **QUALITY_AB)
        got = read("a", t0)
        runs = out["runs"]
        for name, run in runs.items():
            bad = [rec for rec in run["history"] for k, v in rec.items()
                   if k.startswith(("loss", "negative", "consistency"))
                   and not math.isfinite(v)]
            if bad or not run["history"]:
                raise AssertionError(f"(a) {name}: losses {bad[:3]}")
        halo, rnd, none = (out[a][0] for a in acquisition_quality.ARMS)
        base = out["shifted_px_base_rate"]
        shifted = out["halo_budget_on_shifted"]
        if not (shifted >= 2 * base
                and shifted >= 2 * out["random_budget_on_shifted"]):
            raise AssertionError(f"(a) the mechanism: halo's budget on the "
                                 f"shifted classes {shifted}, base rate "
                                 f"{base}, random's "
                                 f"{out['random_budget_on_shifted']}")
        if not (halo > none and rnd > none):
            raise AssertionError(f"(a) halo {halo} / random {rnd} / none "
                                 f"{none}: an annotated arm not above none")
        rounds, batches = 2, math.ceil(12 / 4)  # 12 target images, 4 a batch
        if (got["greedy_picks"] != 2 * rounds * batches
                or got["radius_map"] != 0
                or got["region_score"] != rounds * 12
                or not got["fwd"] > got["dx"] == got["dk"] > 0):
            raise AssertionError(f"(a) launches {got}")
        print(f"quality (a) A/B, seed 0, budget {out['budget']}: halo / "
              f"random / none {halo} / {rnd} / {none} (present-class mIoU; "
              f"halo > random is not asserted); budget on the shifted "
              f"classes halo {shifted:.4f}, random "
              f"{out['random_budget_on_shifted']:.4f}, base rate "
              f"{base:.4f} ({shifted / base:.2f}x the base rate, "
              f"{shifted / out['random_budget_on_shifted']:.2f}x random's); "
              f"on the rare classes halo {out['halo_budget_on_rare']:.4f}, "
              f"random {out['random_budget_on_rare']:.4f}; launches A "
              f"{got['greedy_picks']}, S1 + S2 {got['region_score']}, C "
              f"{got['fwd']} + {got['dx']} + {got['dk']}; {card}",
              flush=True)
        for name, run in runs.items():
            st = run["stages"]
            steps = len(run["history"])
            print(f"quality (a) {name}: {run['seconds']:.2f} s wall, "
                  f"{steps} steps, ms/step {st['step'] / steps * 1e3:.2f} "
                  f"(loader wait {st['load'] / steps * 1e3:.2f}), rounds "
                  f"{st.get('round', 0.0):.3f} s; losses first/last "
                  + json.dumps([{k: round(v, 4) for k, v in rec.items()
                                 if k.startswith("loss")}
                                for rec in (run["history"][0],
                                            run["history"][-1])]),
                  flush=True)

        # (b) the radius-rarity probe on (a)'s pretrain, no new pretrain
        ckpt = work / "out" / "pretrain_s0" / "last.ckpt"
        stamp = ckpt.stat().st_mtime_ns
        zero_counts()
        t0 = time.perf_counter()
        rows = radius_rarity.measure(str(work), seed=0,
                                     pretrain_steps=QUALITY_AB[
                                         "pretrain_steps"], device=DEVICE)
        got = read("b", t0)
        limit = 2 * math.atanh(1 - 1e-7)
        top = sum(r["score_top_share"] for r in rows.values())
        if (ckpt.stat().st_mtime_ns != stamp
                or not all(0 < r["mean_radius"] <= limit
                           for r in rows.values())
                or abs(top - 1) > 1e-6 or got["radius_map"] != 2 * 12):
            raise AssertionError(f"(b) {rows}; top shares sum {top}; "
                                 f"launches {got}")
        print("quality (b) radius rarity (class, mean radius, pixel share, "
              "top-4% score share):", flush=True)
        for name, r in rows.items():
            print(f"  {name:12s} {r['mean_radius']:.6f} "
                  f"{r['px_share']:.6f} {r['score_top_share']:.6f}",
                  flush=True)
        print(f"quality (b): launches B {got['radius_map']}, C "
              f"{got['fwd']}", flush=True)

        # (c) the parity command at full width on a seeded R101
        data = root / "datasets"
        write_cityscapes(data, 2, args.seed + 1, split="val")
        config = REPO / "configs" / "gtav" / "test.yaml"
        overrides = ["TPU.DENSE_CONV_MODE", "pallas", "MODEL.WEIGHTS", "",
                     "TPU.DATASET_DIR", str(data), "OUTPUT_DIR",
                     str(root / "parity")]
        _, cfg = parse_args(["-cfg", str(config), *overrides])
        lightning = root / "halo_r101.ckpt"
        n_keys = lightning_checkpoint(torch, cfg, lightning, args.seed)
        common = ["--ckpt", str(lightning), "--max-batches", "2", "--cfg",
                  str(config)]
        run_s, payloads, codes = [], [], []
        zero_counts()
        t0 = time.perf_counter()
        for extra in (["--budget", "5"], None):
            if extra is None:  # the OK path: the measured mIoU
                extra = ["--expected-miou", str(payloads[0]["miou"])]
            t1 = time.perf_counter()
            code, text = captured(verify_parity.main, ["--device", DEVICE]
                                  + common + extra + overrides)
            torch.cuda.synchronize()
            run_s.append(time.perf_counter() - t1)
            codes.append(code)
            payloads.append(json.loads(text.strip().splitlines()[-1]))
        got = read("c", t0)
        if (codes != [2, 0] or payloads[0]["parity"] != "FAIL"
                or payloads[1]["parity"] != "OK"
                or payloads[0]["miou"] != payloads[1]["miou"]
                or got["fwd"] != 2 * 2 * 25 or got["dx"] != 0):
            raise AssertionError(f"(c) exits {codes}, {payloads}, launches "
                                 f"{got}")
        print(f"quality (c) verify_parity, R101 Lightning checkpoint "
              f"({n_keys} tensors), configs/gtav/test.yaml, 2 of 2 "
              f"1024x2048 val images: exit 2 (FAIL at --budget 5) then 0 at "
              f"--expected-miou, mIoU {payloads[0]['miou']} both times; "
              f"s a run {json.dumps([round(t, 2) for t in run_s])} (the "
              f"model build, the checkpoint load and the loader included); "
              f"kernel C launches {got['fwd']}; {card}",
              flush=True)

        # (d) the quickstart at its defaults
        zero_counts()
        t0 = time.perf_counter()
        res, text = captured(quickstart.main, device=DEVICE)
        got = read("d", t0)
        if (int(res.num_picked) != 100
                or int((res.picks[:, 0] >= 0).sum()) != 100
                or got["greedy_picks"] != 1 or got["radius_map"] != 1):
            raise AssertionError(f"(d) {text}; launches {got}")
        print(f"quality (d) quickstart (R101, 256x512): 100 regions picked "
              f"in {seconds['d']:.2f} s wall (model build included); "
              f"launches A {got['greedy_picks']}, B {got['radius_map']}",
              flush=True)

    report["greedy_picks"]["launches"] += phase["greedy_picks"]
    report["radius_map"]["launches"] += phase["radius_map"]
    report["region_score"]["launches"] += phase["region_score"]
    report["dilated_conv3x3"]["launches"] += phase["fwd"] + phase["dx"]
    report["dilated_conv3x3_wgrad"]["launches"] += phase["dk"]
    print("quality: part seconds " + json.dumps(
        {k: round(v, 2) for k, v in seconds.items()}) + "; phase launches "
        + json.dumps(phase), flush=True)


KERNELS = ("greedy_picks", "radius_map", "region_score", "dilated_conv3x3",
           "dilated_conv3x3_wgrad", "int8_conv", "int8_quant")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--images", type=int, default=8)
    parser.add_argument("--parallel-child", metavar="SPEC.json",
                        help=argparse.SUPPRESS)  # a process of phase parallel
    parser.add_argument("--profile", metavar="TRACE.json",
                        help="trace the round, and 3 train steps in each "
                        "conv mode, with torch.profiler; write the chrome "
                        "traces here (and beside it) and print the device "
                        "busy share and the top kernels")
    args = parser.parse_args()
    if args.parallel_child:
        return parallel_child(args.parallel_child)

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
    with tempfile.TemporaryDirectory() as work:
        # checkpoints one phase writes and a later one reads
        report = {"work": Path(work)}
        seconds = {}
        for phase in (phase_radius, phase_score, phase_select, phase_conv):
            t0 = time.perf_counter()
            phase(torch, gen, report)
            seconds[phase.__name__[6:]] = time.perf_counter() - t0
        for phase in (phase_slice, phase_train, phase_protocols,
                      phase_families, phase_acdc, phase_int8,
                      phase_parallel, phase_quality):
            t0 = time.perf_counter()
            phase(torch, args, report)
            seconds[phase.__name__[6:]] = time.perf_counter() - t0
    print("phase seconds " + json.dumps(
        {k: round(v, 1) for k, v in seconds.items()}), flush=True)
    idle = [k for k in KERNELS if report[k]["launches"] <= 0]
    if idle:
        raise AssertionError(f"kernels no path launched: {idle}")
    print(json.dumps({"kernels": [report[k] for k in KERNELS]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
