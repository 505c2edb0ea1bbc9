"""Where the time of kernel C's weight-gradient kernel goes, on the card:

    python -m halo_tpu_torch.tools.wgrad_probe
    python -m halo_tpu_torch.tools.wgrad_probe --step0 [N]

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

``--step0 N`` (default 20) instead repeats step 0 of the recipe's train
step (``configs/gtav/source_target.yaml``, ``TPU.DENSE_CONV_MODE
pallas``, source 2x720x1280 and target 2x640x1280, seeded weights
restored before each repeat, the batch drawn anew from seed + repeat) and
captures layer3's and layer4's conv2 operands as ``chip_smoke.py`` phase
``train`` does (the first train-mode call's input, weight and cotangent).
For each capture it prints the kernel's dk and the float32 reference's
(``wgrad_taps`` on float32 operands) against the float64 sums
(``wgrad_taps`` on the bf16 operands widened exactly), in ``bf16_steps``'
units, with the worst element and its condition (the float64 sum of the
terms' magnitudes).
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
from pathlib import Path

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
    return build_sources({f"wgrad_{name}": variant_source(name)})[
        f"wgrad_{name}"]


def build_sources(sources: dict, name: str = "dilated_conv_wgrad.cu",
                  headers=("dilated_conv.cuh",),
                  entries=("halo_dilated_conv3x3_wgrad_bf16",
                           "halo_dilated_conv3x3_wgrad_workspace"),
                  match: str = "wgrad") -> dict:
    """Compile each {tag: source of ``name``} (with the ``headers`` of
    ``csrc/`` beside it) into its own library under
    ``build/variants/<tag>/``, one ``nvcc`` each, all started together;
    prints the registers and spills of each kernel whose name holds
    ``match``; returns {tag: ctypes handle with ``entries`` typed}."""
    jobs = {}
    for tag, src in sources.items():
        vdir = kernels.BUILD_DIR.parent / "variants" / tag
        vdir.mkdir(parents=True, exist_ok=True)
        (vdir / name).write_text(src)
        for header in headers:
            (vdir / header).write_text((kernels.CSRC / header).read_text())
        lib = vdir / "libvariant.so"
        jobs[tag] = (lib, subprocess.Popen(
            [kernels._nvcc(), *kernels.ARCH_FLAGS, "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared", "-o",
             str(lib), str(vdir / name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    handles = {}
    for tag, (lib, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {tag}: nvcc failed\n{out}")
        # the kernel's registers and spills (ptxas prints them after the
        # entry's name)
        lines = out.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and match in line:
                print(f"{tag}: " + " | ".join(
                    x.split("ptxas info    :")[-1].strip()
                    for x in lines[i + 1:i + 3]), flush=True)
        handle = ctypes.CDLL(str(lib))
        for entry in entries:
            fn = getattr(handle, entry)
            fn.argtypes = list(kernels._SIGNATURES[entry])
            fn.restype = kernels._RESTYPES.get(entry, ctypes.c_int)
        handles[tag] = handle
    return handles


FLUSH = "constexpr int kFlush = "


def flush_source(steps: int) -> str:
    """The kernel's source with tensor-core runs of at most ``steps`` pixel
    steps (each run then added into the float32 sums, rounded to
    nearest)."""
    src = (kernels.CSRC / "dilated_conv_wgrad.cu").read_text()
    i = src.index(FLUSH) + len(FLUSH)
    return src[:i] + str(steps) + src[src.index(";", i):]


def variant_dk(lib, xh, gh, d: int, plan):
    """dk of a variant library on NHWC bf16 x and cotangent, as
    ``ops/dilated_conv._wgrad`` calls the library."""
    b, h, w, c = xh.shape
    co = gh.shape[3]
    nbytes = lib.halo_dilated_conv3x3_wgrad_workspace(
        b, h, w, c, co, d, plan.period, plan.grid)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=xh.device)
    flags = torch.zeros(2 * plan.tiles + 2, dtype=torch.int32,
                        device=xh.device)
    dk = torch.empty((co, c, 3, 3), dtype=torch.bfloat16, device=xh.device)
    err = lib.halo_dilated_conv3x3_wgrad_bf16(
        xh.data_ptr(), gh.data_ptr(), dk.data_ptr(), ws.data_ptr(), nbytes,
        flags.data_ptr(), flags.numel(), b, h, w, c, co, d, plan.period,
        plan.grid, kernels.current_stream(xh.device))
    kernels.check(err, "halo_dilated_conv3x3_wgrad_bf16")
    return dk


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


def bf16_steps(got, want) -> tuple:
    """(largest |got - want| in bf16 steps of the larger magnitude, the same
    after forgiving 1e-5 of max|want|), in float64: near zero the order of
    the float32 sums decides which way a bf16 output rounds."""
    got, want = got.double(), want.double()
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(2.0 ** -126)
    step = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    diff = (got - want).abs()
    floor = 1e-5 * float(want.abs().max())
    return (float((diff / step).max()),
            float(((diff - floor).clamp_min(0) / step).max()))


def dk_worst(dk, want, x, g, d: int) -> str:
    """The element of ``dk`` farthest beyond the floor from ``want``: its
    (co, c, ky, kx), the kernel's, float32 reference's and float64 sums'
    values, and its condition, the float64 sum of |x| |g| over its terms."""
    ref32 = dc.wgrad_taps(x.float(), g.float(), d)
    ref64 = dc.wgrad_taps(x.double(), g.double(), d)
    got, want = dk.double(), want.double()
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(2.0 ** -126)
    step = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    beyond = ((got - want).abs() - 1e-5 * float(want.abs().max())) / step
    at = tuple(int(i) for i in torch.unravel_index(
        beyond.argmax(), tuple(dk.shape)))
    cond = dc.wgrad_taps(x.double().abs(), g.double().abs(), d)[at]
    return (f"worst (co, c, ky, kx) {at}: kernel {float(dk[at]):.9e}, "
            f"float32 reference {float(ref32[at]):.9e}, float64 "
            f"{float(ref64[at]):.9e}, sum of |terms| {float(cond):.9e}, "
            f"max|dk| {float(ref64.abs().max()):.9e}")


def kernel_dk(x, w, g, d: int):
    """dk of kernel C through autograd, as ``chip_smoke.check_conv`` takes
    it (the weight-gradient kernel on the bf16 operands)."""
    xk = x.detach().clone().requires_grad_(True)
    wk = w.detach().clone().requires_grad_(True)
    dc.dilated_conv3x3(xk, wk, d).backward(g)
    return wk.grad


def _synthetic_batches(cfg, gen, device):
    """A source and a target batch at the recipe's train sizes: normalised
    noise images, source labels of 19 classes, a target mask with ~1% of
    its pixels labelled (as after a round), the rest ignored."""
    def batch(size, mask):
        w, h = size
        b = int(cfg.SOLVER.BATCH_SIZE)
        img = torch.randn((b, h, w, 3), generator=gen, device=device)
        lab = torch.randint(0, 19, (b, h, w), generator=gen, device=device)
        out = {"img": img, "label": lab}
        if mask:
            keep = torch.rand((b, h, w), generator=gen, device=device) < 0.01
            out["mask"] = torch.where(keep, lab, torch.full_like(lab, 255))
        return out
    return {"source": batch(cfg.INPUT.SOURCE_INPUT_SIZE_TRAIN, False),
            "target": batch(cfg.INPUT.TARGET_INPUT_SIZE_TRAIN, True)}


def step0(runs: int = 20, seed: int = 0, device=None, opts=(),
          flushes=()):
    """Repeat step 0 of the recipe's ``pallas`` train step ``runs`` times
    and hold each capture's dk against the float64 sums (module doc);
    ``opts`` are config overrides (KEY VALUE ...), ``device`` "cpu"
    rehearses it (small ``INPUT.*_SIZE_TRAIN`` in ``opts``). ``flushes``
    adds, for each n, a copy of the kernel built with tensor-core runs of
    at most n steps (``flush_source``), held against the float64 sums on
    the same captures and timed at ``SHAPES`` beside the library's
    kernel. Returns the count of captures beyond the bound for each
    comparison."""
    from ..config import get_default_cfg
    from ..engine.optim import build_optimizer
    from ..engine.steps import make_train_step
    from ..models import build_segmentor
    from ..models.layers import DilatedConv3x3

    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device.type == "cuda":
        kernels.load()
    cfg = get_default_cfg()
    cfg.set_new_allowed(True)
    cfg.merge_from_file(str(Path(__file__).resolve().parents[2] / "configs"
                            / "gtav" / "source_target.yaml"))
    cfg.merge_from_list(["TPU.DENSE_CONV_MODE", "pallas", "SEED", str(seed),
                         *opts])
    model = build_segmentor(cfg, device=device,
                            generator=torch.Generator().manual_seed(seed))
    model.train()
    state = {k: v.clone() for k, v in model.state_dict().items()}
    optimizer, _, _ = build_optimizer(cfg, model)
    train_step = make_train_step(cfg, model, optimizer, "source_target")
    captured = {}

    def capture(module, inputs, output):
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

    handle = torch.nn.modules.module.register_module_forward_hook(capture)
    fails = {"kernel vs float64": 0, "float32 vs float64": 0,
             "kernel vs float32 (the check before)": 0}
    fails.update({f"runs of {n} vs float64": 0 for n in flushes})
    fails.update({f"runs of {n} vs float32": 0 for n in flushes})
    worst = {k: 0.0 for k in fails}
    libs = build_sources({f"wgrad_flush{n}": flush_source(n)
                          for n in flushes}) if flushes else {}
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if device.type == "cuda" else 1)
    try:
        for i in range(runs):
            model.load_state_dict(state)
            captured.clear()
            gen = torch.Generator(device=device).manual_seed(seed + i)
            train_step(_synthetic_batches(cfg, gen, device))
            if device.type == "cuda":
                torch.cuda.synchronize()
            for name, e in (("layer3", captured[256]),
                            ("layer4", captured[512])):
                x, g, d = e["x"], e["g"], e["d"]
                dk = kernel_dk(x, e["w"], g, d)
                ref32 = dc.wgrad_taps(x.float(), g.float(), d)
                ref64 = dc.wgrad_taps(x.double(), g.double(), d)
                rows = {"kernel vs float64": bf16_steps(dk, ref64),
                        "float32 vs float64": bf16_steps(ref32, ref64),
                        "kernel vs float32 (the check before)":
                            bf16_steps(dk, ref32)}
                if flushes:
                    b, c, h, w = x.shape
                    co = g.shape[1]
                    plan = dc.wgrad_plan(b, h, w, c, co, d, sms)
                    xh = x.permute(0, 2, 3, 1).contiguous()
                    gh = g.permute(0, 2, 3, 1).contiguous()
                for n in flushes:
                    vk = variant_dk(libs[f"wgrad_flush{n}"], xh, gh, d, plan)
                    rows[f"runs of {n} vs float64"] = bf16_steps(vk, ref64)
                    rows[f"runs of {n} vs float32"] = bf16_steps(vk, ref32)
                line = []
                for k, (strict, floored) in rows.items():
                    worst[k] = max(worst[k], floored)
                    fails[k] += floored > 1.0
                    line.append(f"{k} {strict:.2f} ({floored:.2f} beyond "
                                "1e-5 of max)")
                print(f"step0 run {i} {name} conv2 d={d}: " + "; ".join(line),
                      flush=True)
                if rows["kernel vs float64"][1] > 1.0 or rows[
                        "kernel vs float32 (the check before)"][1] > 1.0:
                    for k, want in (("float64", ref64), ("float32", ref32)):
                        print(f"  against {k}: " + dk_worst(dk, want, x, g, d),
                              flush=True)
    finally:
        handle.remove()
    gen = torch.Generator(device=device).manual_seed(seed)
    for shape in (SHAPES if flushes else ()):
        b, c, co, h, w, d = shape
        xh, gh = _operands(shape, gen, device)
        plan = dc.wgrad_plan(b, h, w, c, co, d, sms)
        times = {"library": _cuda_ms(lambda: dc._wgrad(xh, gh, d))}
        for n in flushes:
            times[f"runs of {n}"] = _cuda_ms(
                lambda n=n: variant_dk(libs[f"wgrad_flush{n}"], xh, gh, d,
                                       plan))
        print(f"step0 dk ms {shape}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in times.items()), flush=True)
    print(f"step0: {runs} runs x 2 captures; captures beyond one bf16 step "
          "past 1e-5 of max|dk|: " + ", ".join(
              f"{k} {v} (worst {worst[k]:.2f})" for k, v in fails.items()),
          flush=True)
    if device.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True)
        print(smi.stdout.strip(), flush=True)
    return fails


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
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--step0", type=int, nargs="?", const=20,
                        metavar="N", help="repeat step 0 of the train step "
                        "N times and hold dk against float64 sums")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--flush", type=int, nargs="*", default=(),
                        metavar="STEPS", help="with --step0: also copies "
                        "of the kernel with tensor-core runs of at most "
                        "STEPS pixel steps, held and timed beside it")
    args = parser.parse_args()
    if args.step0:
        step0(args.step0, args.seed, flushes=tuple(args.flush))
    else:
        main()
