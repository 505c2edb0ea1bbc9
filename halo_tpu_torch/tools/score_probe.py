"""Where the time of the round's score stage goes, on the card:

    python -m halo_tpu_torch.tools.score_probe [--native 1024 2048]

Scores 8 seeded images (seed 0) the way the round of
``configs/gtav/source_target.yaml`` does: ``active.scoring.
fused_upsample_region_score`` on the head's outputs (float32 logits of 19
classes at 640x1280, normal x 3; a float32 64-wide ball embedding at
160x320, radii uniform in [0, 0.95)), entropy x radius, window 3,
normalised, score dtype bf16, at the native size. It prints one
``score_probe`` JSON line:

- ``first_ms``: the process's first call, synchronised, the kernels'
  library already loaded: what the first image of a round pays for the
  interpolation tables (built and uploaded once a size); ``warm_ms``, a
  later call of the same image, synchronised; ``label_ms``, the median
  upload of an image's uint8 label map with its widening to int32, as the
  round's score stage makes it;
- ``ms``: the call's device time between CUDA events, the median over
  three passes of the images in turn (each image's inputs, 75 MB, come
  from device memory and not from L2), and ``host_ms``, the median time
  until the call returns (not synchronised);
- from torch.profiler over one call: ``kernels`` (device kernels launched,
  copies and fills apart), ``copies``, ``device_ms`` (all device time) and
  the five kernels that took the most;
- the launches a call of kernel B (``cuda_radius.launches``) and, in a
  tree that has it, of the score kernel pair (``cuda_score.launches``);
- ``sha256`` of the first image's score map: two trees give the same hash
  when they compute the same bits;
- in a tree with the score kernel pair, ``variants``: S1's median ms in
  copies of ``csrc/region_score.cu`` built under ``build/variants/``
  with one part taken out (``VARIANTS``), beside the unchanged source:
  what each part costs.

It only calls the scoring function, so it runs against any tree of the
port: to compare a parent tree, copy this file into its
``halo_tpu_torch/tools/`` and run both in one call. ``--device cpu
--native 64 128`` rehearses it without a card (no device times then).
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from .. import kernels
from ..active import cuda_radius
from ..active.scoring import fused_upsample_region_score
from ..device import resolve_device

IMAGES = 8
SEED = 0
LOGITS_HW = (640, 1280)
EMBED_HW = (160, 320)
DTYPE = torch.bfloat16

# S1 with one part taken out, each an edit of csrc/region_score.cu:
# (text to find, its replacement). The maps of a variant are wrong; only
# its time is read.
VARIANTS = {
    # no reads of the inputs: the bands are not staged
    "noload": ("stage_one(dst + i * plane, src + (long long)i * s.sr);",
               ";"),
    # no exponential in the entropy
    "noexp": ("const float ev = expf(v);", "const float ev = v;"),
    # the logits' chunks skipped: no entropy
    "nologits": ("const int n_l = (p.lg.ch + p.ck_l - 1) / p.ck_l;",
                 "const int n_l = 0;"),
    # the embedding's chunks skipped: no radius
    "noembed": ("const int n = n_l + (p.em.ch + p.ck_e - 1) / p.ck_e;",
                "const int n = n_l;"),
}


def inputs(n: int, device):
    """``n`` seeded (logits, embedding) pairs at the head's resolutions."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    out = []
    for _ in range(n):
        lg = torch.randn(LOGITS_HW + (19,), generator=gen,
                         device=device) * 3.0
        x = torch.randn(EMBED_HW + (64,), generator=gen, device=device)
        r = torch.rand(EMBED_HW + (1,), generator=gen, device=device) * 0.95
        out.append((lg, x / x.norm(dim=-1, keepdim=True) * r))
    return out


def score(lg, em, native):
    return fused_upsample_region_score(lg, em, tuple(native),
                                       score_dtype=DTYPE)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _wall_ms(fn, device) -> float:
    _sync(device)
    t0 = time.perf_counter()
    fn()
    _sync(device)
    return (time.perf_counter() - t0) * 1e3


def _rotated_ms(fn, n: int, iters: int) -> float:
    """Median device ms of fn(i) over ``iters`` calls, i cycling over n
    inputs, each call between its own pair of CUDA events, queued behind
    a spin kernel so the device runs them back to back (the host's launch
    work is not timed)."""
    for i in range(2):
        fn(i)
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(200_000_000)  # clock cycles
    for i, (start, end) in enumerate(events):
        start.record()
        fn(i % n)
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def variant_ms(cuda_score, data, native) -> dict:
    """S1's median ms in each variant's library and in the unchanged
    source's, built side by side."""
    from .wgrad_probe import build_sources
    src = (kernels.CSRC / "region_score.cu").read_text()
    sources = {"score_base": src}
    for name, (find, repl) in VARIANTS.items():
        if find not in src:
            raise RuntimeError(f"variant {name}: {find!r} is not in "
                               "region_score.cu")
        sources[f"score_{name}"] = src.replace(find, repl)
    libs = build_sources(sources, name="region_score.cu", headers=(),
                         entries=("halo_region_score_s1",),
                         match="score_tile")
    H, W = native
    out = {}
    for tag, lib in libs.items():
        out[tag[len("score_"):]] = _rotated_ms(
            lambda i, lib=lib: cuda_score._launch_s1(
                *data[i], H, W, DTYPE, 1, 1.0, lib=lib), len(data),
            3 * len(data))
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--native", type=int, nargs=2, default=(1024, 2048))
    parser.add_argument("--device", default=None)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    native = tuple(args.native)
    cuda = device.type == "cuda"
    try:  # the score kernel pair, where the tree has it
        cuda_score = importlib.import_module(
            "..active.cuda_score", __package__)
    except ImportError:
        cuda_score = None
    if cuda:
        kernels.load()
    data = inputs(IMAGES, device)
    label = np.random.default_rng(SEED).integers(
        0, 19, native, dtype=np.uint8)
    first = []
    first_ms = _wall_ms(lambda: first.append(score(*data[0], native)[0]),
                        device)
    digest = hashlib.sha256(
        first[0].cpu().numpy().tobytes()).hexdigest()[:16]
    out = {"native": list(native), "logits": list(LOGITS_HW),
           "embed": list(EMBED_HW), "dtype": str(DTYPE)[6:],
           "sha256": digest, "first_ms": first_ms,
           "warm_ms": _wall_ms(lambda: score(*data[0], native), device),
           "label_ms": statistics.median(_wall_ms(
               lambda: torch.as_tensor(label, device=device).to(
                   torch.int32), device) for _ in range(IMAGES))}

    cuda_radius.launches = 0
    if cuda_score is not None:
        cuda_score.launches = 0
    score(*data[0], native)
    out["radius_launches"] = cuda_radius.launches
    out["score_launches"] = (cuda_score.launches if cuda_score is not None
                             else None)

    host, dev = [], []
    for i in range(3 * IMAGES):
        lg, em = data[i % IMAGES]
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
        t0 = time.perf_counter()
        score(lg, em, native)
        host.append((time.perf_counter() - t0) * 1e3)
        if cuda:
            end.record()
            end.synchronize()
            dev.append(start.elapsed_time(end))
    out["host_ms"] = statistics.median(host)
    out["ms"] = statistics.median(dev) if cuda else None

    if cuda:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            score(*data[1 % IMAGES], native)
            torch.cuda.synchronize()
        kernel_count = copies = 0
        device_ms = 0.0
        by_name = {}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            if "memcpy" in e.key.lower() or "memset" in e.key.lower():
                copies += e.count
            else:
                kernel_count += e.count
            device_ms += e.self_device_time_total / 1e3
            by_name[e.key[:80]] = e.self_device_time_total / 1e3
        out.update(kernels=kernel_count, copies=copies, device_ms=device_ms,
                   top=[[k, round(v, 4)] for k, v in sorted(
                       by_name.items(), key=lambda kv: -kv[1])[:5]])
        if cuda_score is not None:
            out["variants"] = variant_ms(cuda_score, data, native)
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    print("score_probe " + json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
