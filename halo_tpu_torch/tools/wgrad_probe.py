"""Where the time of kernel C's weight-gradient kernel goes, on the card:

    python -m halo_tpu_torch.tools.wgrad_probe

Builds copies of ``csrc/dilated_conv_wgrad.cu`` beside the library
(``build/variants/wgrad_<name>/``) that stamp ``%globaltimer`` into a
device array at the kernel's phases (start, the pixel steps done, the
partial stored, the wait for the other partials done, the share summed,
the grid barrier passed, the transposition done), each with one edit:

- ``base``    none: the kernel as it is;
- ``noload``  no TMA load: the producer arrives on the stage's barrier
              with no bytes, the products run on whatever the ring holds;
- ``nomma``   no product: the consumers wait for each stage and free it;
- ``divide``  each step's pixel step and its (b, row, column) computed by
              integer division again, in the producer and the consumers.

For each it prints, at the recipe's five dk shapes (R101 layer3 and layer4
at the source's 2x90x160 and the target's 2x80x160) under the wrapper's
plan, and at layer3 on 16 blocks, the median microseconds of a pixel step,
the longest block's steps and the median time of each later phase, from
the last of 4 calls. Then it
times the library's kernel (CUDA events, median of 50 calls) under three
plans: the wrapper's, the plan in which every block takes one residue of
one tile (the blocks sweep the image together) and the stream-K plan (P =
the pixel steps, a contiguous range a block); and cuDNN's wgrad beside
them. Raises without a CUDA device. To try a change before editing the
kernel, add a variant to ``VARIANTS``.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess

import torch

from .. import kernels
from ..device import resolve_device
from ..ops import dilated_conv as dc

# (B, C, Co, H, W, d)
SHAPES = ((2, 256, 256, 90, 160, 2), (2, 512, 512, 90, 160, 2),
          (2, 512, 512, 90, 160, 4), (2, 256, 256, 80, 160, 2),
          (2, 512, 512, 80, 160, 4))
STAMPS = 7


def _stamp(k: int) -> str:
    who = "threadIdx.x == 0" if k == 0 else "threadIdx.x == 128"
    return (f"\n  if ({who}) {{ unsigned long long t_; asm volatile("
            f"\"mov.u64 %0, %globaltimer;\" : \"=l\"(t_)); "
            f"g_probe[blockIdx.x * {STAMPS} + {k}] = t_; }}\n")


def _after(src: str, anchor: str, text: str) -> str:
    i = src.index(anchor) + len(anchor)
    return src[:i] + text + src[i:]


def _cut(src: str, start: str, end: str, text: str = "") -> str:
    """src with [start, end) replaced by text (end searched after start)."""
    i = src.index(start)
    return src[:i] + text + src[src.index(end, i):]


VARIANTS = {
    "base": lambda s: s,
    "noload": lambda s: _cut(s, "          mbar_expect_tx(bar, a.stage_bytes);",
                             "          if (++s == a.stages) {",
                             "          mbar_arrive(bar);\n"),
    "nomma": lambda s: _cut(s, "        fence_acc(acc);\n        wgmma_fence();",
                            "        if (step > 0 && lane == 0)"),
    "divide": lambda s: _divide(s),
}


def _divide(src: str) -> str:
    """The stage, its parity and the pixel step's (b, row, column) by
    division again, where the waits and loads need them."""
    for lead in ("      ", "    "):  # the producer's, the consumers'
        src = src.replace(f"{lead}int s = 0;\n{lead}uint32_t phase = 0;\n",
                          f"{lead}int s = 0;\n{lead}uint32_t phase = 0;\n"
                          f"{lead}int it_ = 0;\n", 1)
    src = src.replace("if (++s == a.stages) {", "++it_;\n          "
                      "if (++s == a.stages) {")
    src = src.replace(
        "mbar_wait(empty_bar + 8 * s, phase ^ 1);",
        "mbar_wait(empty_bar + 8 * (it_ % a.stages), "
        "((it_ / a.stages) & 1) ^ 1);", 1)
    src = src.replace(
        "mbar_wait(full_bar + 8 * s, phase);",
        "mbar_wait(full_bar + 8 * (it_ % a.stages), (it_ / a.stages) & 1);",
        1)
    src = src.replace(
        "          const int w0 = tw * a.wsz;",
        "          tw = kt % a.tiles_w;\n          th = kt / a.tiles_w % "
        "a.tiles_h;\n          b = kt / a.tiles_w / a.tiles_h;\n"
        "          const int w0 = tw * a.wsz;", 1)
    return src.replace(
        "for (int step = 0; step < steps; ++step) {",
        "for (int step = 0; step < steps && (step / (r1 - r0)) * P + r0 + "
        "step % (r1 - r0) < a.KT; ++step) {", 1)


def variant_source(name: str) -> str:
    """The kernel's source with the phase stamps and the variant's edit."""
    src = (kernels.CSRC / "dilated_conv_wgrad.cu").read_text()
    src = VARIANTS[name](src)
    src = src.replace("__global__ void __launch_bounds__",
                      "__device__ unsigned long long g_probe[1024 * "
                      f"{STAMPS}];\n__global__ void __launch_bounds__", 1)
    src = _after(src, "  __syncthreads();\n", _stamp(0))
    src = _after(src, "      wgmma_wait<0>();\n      fence_acc(acc);\n"
                 "      if (lane == 0) mbar_arrive(empty_bar + 8 * held);\n",
                 _stamp(1))
    src = _after(src, "      __threadfence();\n      consumer_sync();\n",
                 _stamp(2))
    src = _after(src, "      if (!finisher) continue;\n      consumer_sync();\n",
                 _stamp(3))
    src = src.replace("    // Every tile is in s9", _stamp(4)
                      + "    // Every tile is in s9", 1)
    src = _after(src, "static_cast<unsigned>(G), true);\n    consumer_sync();\n",
                 _stamp(5))
    src = _after(src, "      consumer_sync();\n    }\n  }\n", _stamp(6))
    return src + (
        "\nextern \"C\" int halo_wgrad_probe(void* host) {\n"
        "  return (int)cudaMemcpyFromSymbol(host, g_probe, sizeof(g_probe));"
        "\n}\n")


def build_variant(name: str):
    """Compile a variant into its own library; returns the ctypes handle."""
    vdir = kernels.BUILD_DIR.parent / "variants" / f"wgrad_{name}"
    vdir.mkdir(parents=True, exist_ok=True)
    (vdir / "dilated_conv_wgrad.cu").write_text(variant_source(name))
    (vdir / "dilated_conv.cuh").write_text(
        (kernels.CSRC / "dilated_conv.cuh").read_text())
    lib = vdir / "libwgrad.so"
    proc = subprocess.run(
        [kernels._nvcc(), *kernels.ARCH_FLAGS, "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-shared", "-o", str(lib),
         str(vdir / "dilated_conv_wgrad.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"variant {name}: nvcc failed\n{proc.stderr}")
    handle = ctypes.CDLL(str(lib))
    for entry in ("halo_dilated_conv3x3_wgrad_bf16",
                  "halo_dilated_conv3x3_wgrad_workspace"):
        fn = getattr(handle, entry)
        fn.argtypes = list(kernels._SIGNATURES[entry])
        fn.restype = kernels._RESTYPES.get(entry, ctypes.c_int)
    return handle


def _operands(shape, gen, device):
    b, c, co, h, w, _d = shape
    x = torch.randn((b, h, w, c), generator=gen, device=device)
    g = torch.randn((b, h, w, co), generator=gen, device=device)
    return x.to(torch.bfloat16), g.to(torch.bfloat16)


def phases(lib, shape, x, g, plan) -> dict:
    """Median microseconds of each phase of the variant's last of 4 calls
    (the phases a block does not reach are left out of their median)."""
    b, c, co, h, w, d = shape
    nbytes = lib.halo_dilated_conv3x3_wgrad_workspace(
        b, h, w, c, co, d, plan.period, plan.grid)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    flags = torch.zeros(2 * plan.tiles + 2, dtype=torch.int32,
                        device=x.device)
    dk = torch.empty((co, c, 3, 3), dtype=torch.bfloat16, device=x.device)
    for _ in range(4):
        err = lib.halo_dilated_conv3x3_wgrad_bf16(
            x.data_ptr(), g.data_ptr(), dk.data_ptr(), ws.data_ptr(), nbytes,
            flags.data_ptr(), flags.numel(), b, h, w, c, co, d, plan.period,
            plan.grid, kernels.current_stream(x.device))
        kernels.check(err, "halo_dilated_conv3x3_wgrad_bf16")
        torch.cuda.synchronize()
    # a stamp older than this call's first start is a phase the block did
    # not reach in this call
    buf = (ctypes.c_ulonglong * (1024 * STAMPS))()
    if lib.halo_wgrad_probe(buf) != 0:
        raise RuntimeError("cudaMemcpyFromSymbol failed")
    t = torch.tensor(list(buf), dtype=torch.float64).reshape(
        1024, STAMPS)[:plan.grid]
    t0 = float(t[:, 0].min())
    rel = (t - t0) / 1e3
    steps = [sum(plan.segment_steps(r0, r1) for _, r0, r1
                 in plan.segments(blk)) for blk in range(plan.grid)]

    def med(k, j):
        vals = [float(rel[i, k] - rel[i, j]) for i in range(plan.grid)
                if t[i, k] >= t0 and t[i, j] >= t0 and rel[i, k] >= rel[i, j]]
        return statistics.median(vals) if vals else float("nan")
    return {"us_a_step": statistics.median(
                float(rel[i, 1] - rel[i, 0]) / steps[i]
                for i in range(plan.grid)),
            "most_steps": max(steps),
            "steps_done": float(rel[:, 1].max()),
            "partial_stored": med(2, 1), "waited": med(3, 2),
            "summed": med(4, 3), "grid_barrier": med(5, 4),
            "transposed": med(6, 5), "span": float(rel[:, 6].max())}


def main(variants=tuple(VARIANTS)):
    device = resolve_device(None)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    kernels.load()
    gen = torch.Generator(device=device).manual_seed(0)
    operands = [_operands(s, gen, device) for s in SHAPES]
    for name in variants:
        lib = build_variant(name)
        runs = [(shape, xg, None) for shape, xg in zip(SHAPES, operands)]
        # layer3 on 16 blocks, stream-K: is a step bound by the SM or by L2?
        runs.append((SHAPES[0], operands[0], 16))
        for shape, (x, g), few in runs:
            b, c, co, h, w, d = shape
            plan = dc.wgrad_plan(b, h, w, c, co, d, sms)
            if few:
                plan = plan._replace(period=plan.steps, grid=few)
            got = phases(lib, shape, x, g, plan)
            print(f"wgrad_probe {name} {shape} P={plan.period} "
                  f"G={plan.grid}: " + ", ".join(
                      f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                      for k, v in got.items()), flush=True)
    for shape, (x, g) in zip(SHAPES, operands):
        b, c, co, h, w, d = shape
        auto = dc.wgrad_plan(b, h, w, c, co, d, sms)
        sweep = max(1, min(auto.steps, sms // auto.tiles))
        plans = {"wrapper": auto,
                 "sweep": auto._replace(period=sweep,
                                        grid=auto.tiles * sweep),
                 "stream-K": auto._replace(period=auto.steps, grid=sms)}
        times = {k: _cuda_ms(lambda p=p: dc._wgrad(x, g, d, p))
                 for k, p in plans.items()}
        xc = x.permute(0, 3, 1, 2)
        gc = g.permute(0, 3, 1, 2)
        wt = torch.empty((co, c, 3, 3), dtype=torch.bfloat16,
                         device=device).contiguous(
                             memory_format=torch.channels_last)
        times["cuDNN wgrad"] = _cuda_ms(
            lambda: torch.ops.aten.convolution_backward(
                gc, xc, wt, None, [1, 1], [d, d], [d, d], False, [0, 0], 1,
                [False, True, False]))
        print(f"wgrad_probe plans {shape}: " + ", ".join(
            f"{k} ({plans[k].period}, {plans[k].grid}) {v:.4f} ms"
            if k in plans else f"{k} {v:.4f} ms" for k, v in times.items()),
            flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)


def _cuda_ms(fn, iters: int = 50) -> float:
    """Median ms of fn over ``iters`` calls, each between its own pair of
    CUDA events, queued behind a spin kernel so the device runs them back
    to back."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(200_000_000)
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


if __name__ == "__main__":
    main()
