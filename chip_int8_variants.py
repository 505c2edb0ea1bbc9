#!/usr/bin/env python3
"""Time variants of the int8 path's kernels on one NVIDIA GPU.

    python3 chip_int8_variants.py

Each variant is a text edit of a source in halo_tpu_torch/csrc/, built
beside the library with nvcc (build/variants/) and called through the
port's own wrappers (ops/quant.py) in place of the library's entry, at
the shapes of chip_smoke.py's phase int8 (B = 2, bf16): kernel I's k x k
convs and one-tap GEMMs, kernel Q's inputs. Every line gives each
variant's median ms between CUDA events and whether its output equals
the kernel's ("=", bit for bit; a diagnostic variant may differ).

Kernel I (csrc/int8_conv.cu):
  kernel            as built
  no-store          the epilogue writes nothing to device memory
  no-mma            no wgmma: the TMA ring and the barriers alone
  loads-only        both: what the operand loads alone take
  one-block-at-64   one block an SM at 64-wide tiles too
Kernel Q (csrc/int8_quant.cu):
  kernel            as built (an IEEE division an element)
  reciprocal        a product by the reciprocal instead: not the same
                    bits; what the division costs
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import types
from pathlib import Path

REPO = Path(__file__).resolve().parent
CSRC = REPO / "halo_tpu_torch" / "csrc"
OUT = REPO / "build" / "variants"

STORE = "      if (ho >= g.Ho || wo >= g.Wo || co >= g.Co) continue;"
MMA = ("      wgmma_s8<N>(acc, da + 2 * kk, db + 2 * kk, (step > 0 || kk > 0) "
       "? 1 : 0);")
DIV = "rintf(__fdiv_rn(v, sx))"


def conv_variants(src: str) -> dict:
    for text in (STORE, MMA, "BN == 64"):
        if text not in src:
            raise SystemExit(f"int8_conv.cu no longer holds {text!r}")
    no_store = STORE.replace("continue;", "continue;\n      continue;")
    return {"kernel": src,
            "no-store": src.replace(STORE, no_store),
            "no-mma": src.replace(MMA, "      ;"),
            "loads-only": src.replace(STORE, no_store).replace(MMA, "      ;"),
            "one-block-at-64": src.replace("BN == 64", "BN == 0")}


def quant_variants(src: str) -> dict:
    if DIV not in src:
        raise SystemExit(f"int8_quant.cu no longer holds {DIV!r}")
    return {"kernel": src, "reciprocal": src.replace(
        DIV, "rintf(v * __frcp_rn(sx))")}


def build(kernels, variants: dict, stem: str, entry: str) -> dict:
    """Compile every variant in parallel; {name: a stand-in library}."""
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "dilated_conv.cuh").write_text(
        (CSRC / "dilated_conv.cuh").read_text())
    procs = {}
    for name, text in variants.items():
        src = OUT / f"{stem}_{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels.ARCH_FLAGS, "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-shared", str(src), "-o",
             str(src.with_suffix(".so"))], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{stem} {name}: build failed\n{log[-3000:]}")
        fn = getattr(ctypes.CDLL(str(OUT / f"{stem}_{name}.so")), entry)
        fn.argtypes = list(kernels._SIGNATURES[entry])
        fn.restype = ctypes.c_int
        libs[name] = types.SimpleNamespace(**{entry: fn})
    return libs


def compare(torch, kernels, libs, call, label):
    """One line: each variant's ms for ``call()`` and its output against
    the kernel's."""
    import chip_smoke
    real, ref, row = kernels.load, None, []
    for name, lib in libs.items():
        kernels.load = lambda lib=lib: lib
        try:
            out = call()
            ms = chip_smoke.cuda_ms(torch, lambda i: call(), 20)
        finally:
            kernels.load = real
        if ref is None:
            ref = out
        same = "" if out is ref else (" =" if torch.equal(out, ref)
                                      else " differs")
        row.append(f"{name} {ms:.4f}{same}")
    print(f"{label}: " + "; ".join(row), flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_int8_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from halo_tpu_torch import kernels
    from halo_tpu_torch.ops import quant

    kernels.load()
    conv_libs = build(kernels, conv_variants(
        (CSRC / "int8_conv.cu").read_text()), "int8_conv", "halo_int8_conv")
    quant_libs = build(kernels, quant_variants(
        (CSRC / "int8_quant.cu").read_text()), "int8_quant",
        "halo_int8_quantize")
    print(chip_smoke.card_line(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    amax = torch.tensor(3.0, device="cuda")
    shapes = [(label, c, co, h, w, k, s, d)
              for label, c, co, h, w, k, s, d in chip_smoke.INT8_CASES]
    shapes += [(label, kk, n, 1, m, 1, 1, 1)
               for label, m, kk, n in chip_smoke.INT8_GEMMS]
    for label, c, co, h, w, k, s, d in shapes:
        b = 1 if h == 1 else 2    # a GEMM's M already counts B = 2
        x = (torch.randn((b, c, h, w), generator=gen, device="cuda") * 2).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        wq = torch.randint(-127, 128, (co, c, k, k), generator=gen,
                           device="cuda", dtype=torch.int8)
        w_scale = torch.rand((co,), generator=gen, device="cuda") * 1e-2
        packed = quant.pack_weight(wq)
        xq = quant.quantize_nhwc(x, amax)
        p = d * (k - 1) // 2
        compare(torch, kernels, conv_libs, lambda: quant.int8_conv_kernel(
            xq, packed, w_scale, amax, k, s, p, d, torch.bfloat16),
            f"I {label}")
        compare(torch, kernels, quant_libs,
                lambda: quant.quantize_nhwc(x, amax), f"Q {label} input")
        del x, wq, w_scale, packed, xq
    parts = [(torch.randn((2, 512, 80, 160), generator=gen, device="cuda")
              .to(torch.bfloat16)
              .contiguous(memory_format=torch.channels_last))
             for _ in range(4)]
    pooled = torch.randn((2, 512, 1, 1), generator=gen, device="cuda")
    x = torch.cat([pooled.to(torch.bfloat16).expand(-1, -1, 80, 160)] + parts,
                  dim=1)
    compare(torch, kernels, quant_libs, lambda: quant.quantize_nhwc(x, amax),
            "Q the ASPP concatenation (2, 2560, 80, 160), not channels-last")
    return 0


if __name__ == "__main__":
    sys.exit(main())
