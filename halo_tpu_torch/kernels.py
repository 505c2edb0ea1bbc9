"""Build and load the port's CUDA kernels.

The sources are ``halo_tpu_torch/csrc/*.cu`` (with the headers beside
them), plain CUDA C++ with a C interface. At first use they are compiled
for Hopper (``sm_90a``), one ``nvcc`` per source, all started together,
and linked into one shared library that ``ctypes`` loads. The library
goes to ``build/cuda/`` at the root of the checkout (listed in
``.gitignore``), named by a hash of the sources, so a changed source
rebuilds and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "cuda"
SOURCES = ("dilated_conv.cu", "dilated_conv_wgrad.cu", "int8_conv.cu",
           "int8_quant.cu", "radius.cu", "select.cu")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_lock = threading.Lock()
_lib = None

# C entry points: name -> argtypes; each returns a cudaError_t as int,
# except those in _RESTYPES.
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_SIGNATURES = {
    "halo_radius_map_bf16": (_P, _P, _LL, _I, _I, _F, _F, _P),
    "halo_radius_map_f32": (_P, _P, _LL, _I, _I, _F, _F, _P),
    "halo_greedy_picks": (_P, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    "halo_dilated_conv3x3_bf16": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "halo_dilated_conv3x3_f32": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "halo_dilated_conv3x3_wgrad_bf16": (_P, _P, _P, _P, _LL, _I, _I, _I, _I,
                                        _I, _I, _P),
    "halo_dilated_conv3x3_wgrad_workspace": (_I, _I, _I, _I, _I, _I),
    "halo_int8_conv": (_P, _P, _P, _P, _P, _I) + (_I,) * 16 + (_F, _F, _P),
    "halo_int8_quantize": (_P, _I, _P, _P, _I, _I, _I, _I, _LL, _LL, _LL,
                           _LL, _I, _F, _F, _P),
}
_RESTYPES = {"halo_dilated_conv3x3_wgrad_workspace": _LL}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "halo_tpu_torch/csrc with the CUDA toolkit")
    return found


def library_path() -> Path:
    digest = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode() + path.read_bytes())
    digest.update(" ".join(ARCH_FLAGS).encode())
    return BUILD_DIR / f"libhalo_kernels_{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the sources (in parallel) and link the library; returns its
    path. ``nvcc``'s output, ``-Xptxas -v`` register and shared-memory
    counts included, goes to ``build/cuda/build.log``."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for name in SOURCES:
        obj = BUILD_DIR / (Path(name).stem + f".{os.getpid()}.o")
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-c", str(CSRC / name), "-o", str(obj)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = []
    failed = []
    for cmd, _obj, proc in jobs:
        out, _ = proc.communicate()
        log.append("$ " + " ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(cmd[-3])
    if not failed:
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp),
               *(str(obj) for _c, obj, _p in jobs)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        log.append("$ " + " ".join(cmd) + "\n" + proc.stdout)
        if proc.returncode != 0:
            failed.append("link")
        else:
            os.replace(tmp, lib)
    for _c, obj, _p in jobs:
        obj.unlink(missing_ok=True)
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"CUDA kernel build failed ({', '.join(failed)}):"
                           "\n" + "\n".join(log))
    return lib


def load():
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = _RESTYPES.get(name, ctypes.c_int)
            lib.halo_cuda_error_string.argtypes = [ctypes.c_int]
            lib.halo_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(err: int, name: str):
    """Raise on a non-zero cudaError_t from a C entry point."""
    if err != 0:
        text = _lib.halo_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({text}) at launch")


def current_stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
