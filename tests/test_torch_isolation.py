"""The port stands alone: halo_tpu_torch and chip_smoke.py import nothing
of JAX or of the JAX package (nor matplotlib when a module is imported),
and the entry points refuse to run without CUDA unless the caller asks for
the CPU."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "halo_tpu"}


def _port_files():
    files = sorted((REPO / "halo_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [alias.name.split(".")[0] for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [(node.module or "").split(".")[0]]
        else:
            continue
        assert not FORBIDDEN & set(roots), (
            f"{path.relative_to(REPO)}:{node.lineno} imports {roots}")


# Modules of the slices so far that must be among those walked.
SLICE_MODULES = {"halo_tpu_torch.test", "halo_tpu_torch.train",
                 "halo_tpu_torch.models.pretrained",
                 "halo_tpu_torch.models.build",
                 "halo_tpu_torch.models.classifier",
                 "halo_tpu_torch.models.segformer",
                 "halo_tpu_torch.data.acdc",
                 "halo_tpu_torch.ops.prng", "halo_tpu_torch.ops.quant",
                 "halo_tpu_torch.engine.learners",
                 "halo_tpu_torch.engine.state", "halo_tpu_torch.engine.steps",
                 "halo_tpu_torch.data.datasets",
                 "halo_tpu_torch.data.catalog",
                 "halo_tpu_torch.utils.visualize",
                 "halo_tpu_torch.utils.profiling",
                 "halo_tpu_torch.parallel.mesh",
                 "halo_tpu_torch.parallel.multihost",
                 "halo_tpu_torch.parallel.collectives",
                 "halo_tpu_torch.parallel.launch",
                 "halo_tpu_torch.active.region_selection"}


def test_every_module_imports_with_jax_blocked():
    blocked = sorted(FORBIDDEN | {"matplotlib"})
    code = (
        "import sys, pkgutil, importlib\n"
        f"for name in {blocked!r}:\n"
        "    sys.modules[name] = None  # any import of it raises\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import halo_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    halo_tpu_torch.__path__, 'halo_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "print(' '.join(mods))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr
    mods = set(out.stdout.split("\n")[-2].split())
    assert len(mods) >= 25 and SLICE_MODULES <= mods, SLICE_MODULES - mods


def test_entry_points_need_cuda_or_explicit_cpu(monkeypatch, tmp_path):
    from halo_tpu_torch.active.region_selection import region_selection
    from halo_tpu_torch.config import get_default_cfg
    from halo_tpu_torch.models import build_segmentor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_default_cfg()
    cfg.MODEL.NAME = "deeplabv3plus_resnettiny"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_segmentor(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        region_selection(cfg, None, [], 0)
    model = build_segmentor(cfg, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    assert region_selection(cfg, model, [], 0, device="cpu") == {
        "images": 0, "picked": 0, "labeled_px": 0}


def test_wrappers_refuse_other_devices():
    from halo_tpu_torch.active import cuda_radius, cuda_select
    from halo_tpu_torch.ops import quant
    with pytest.raises(ValueError):
        cuda_select.greedy_picks(torch.zeros((4, 4), device="meta"),
                                 num_picks=1, mask_radius=1)
    with pytest.raises(ValueError):
        cuda_radius.radius_map(torch.zeros((4, 4, 8), device="meta"))
    q = torch.zeros((1, 4, 4, 16), dtype=torch.int8, device="meta")
    w = torch.zeros((16, 144), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError):
        quant.int8_conv_kernel(q, w, torch.ones(16, device="meta"),
                               torch.ones((), device="meta"), 3)
    with pytest.raises(ValueError):
        quant.quantize_nhwc(torch.zeros((1, 16, 4, 4), device="meta"),
                            torch.ones((), device="meta"))


def test_int8_paths_on_cuda_never_take_the_plain_versions(monkeypatch):
    """The int8 wrappers' CUDA branch, driven with CPU tensors taken for
    CUDA ones: every quantised layer's route (a k x k conv, a strided 1x1
    conv, a dense layer on a 3-D input) launches kernel Q, then kernel I
    (the entries of a stand-in library here), and raises on an error; the
    plain versions and ``torch._int_mm`` are never called, and nothing
    falls back."""
    from halo_tpu_torch import kernels
    from halo_tpu_torch.ops import quant

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the CUDA path")

    launched, fail = [], []

    class Library:
        """Q succeeds; I returns cudaErrorIllegalAddress (700) while
        ``fail`` holds an entry."""

        def halo_int8_quantize(self, *args):
            launched.append("Q")
            return 0

        def halo_int8_conv(self, *args):
            launched.append("I")
            return 700 if fail else 0

    monkeypatch.setattr(quant, "_device_is_cuda", lambda t, name: True)
    for name in ("int8_conv_plain", "int8_gemm_plain", "quantize_nhwc_plain",
                 "quantize_act"):
        monkeypatch.setattr(quant, name, refuse)
    monkeypatch.setattr(torch, "_int_mm", refuse)
    monkeypatch.setattr(kernels, "load", Library)
    monkeypatch.setattr(kernels, "current_stream", lambda device: 0)

    def check(err, name):
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")

    monkeypatch.setattr(kernels, "check", check)
    x = torch.randn(1, 32, 6, 7)
    amax = x.abs().max()
    w_int8, w_scale = quant.quantize_weight(torch.randn(48, 32, 3, 3))
    n, nq = quant.launches, quant.quant_launches
    y = quant.int8_conv(x, w_int8, w_scale, amax, 1, 1, 1)
    assert y.shape == (1, 48, 6, 7) and launched == ["Q", "I"]
    assert (quant.launches, quant.quant_launches) == (n + 1, nq + 1)
    fail.append(True)
    with pytest.raises(RuntimeError, match="CUDA error"):
        quant.int8_conv(x, w_int8, w_scale, amax, 1, 1, 1)
    assert quant.launches == n + 1 and launched == ["Q", "I", "Q", "I"]
    fail.clear()
    y = quant.int8_conv(x, w_int8[:, :, :1, :1].contiguous(), w_scale,
                        amax, 2)
    assert y.shape == (1, 48, 3, 4) and launched[4:] == ["Q", "I"]
    y = quant.int8_dense(torch.randn(2, 5, 32), w_int8[:, :, 0, 0], w_scale,
                         amax)
    assert y.shape == (2, 5, 48) and launched[6:] == ["Q", "I"]
    assert (quant.launches, quant.quant_launches) == (n + 3, nq + 4)
    with pytest.raises(TypeError):    # no float16 output on the card
        quant.int8_conv(x, w_int8, w_scale, amax, 1, 1, 1,
                        out_dtype=torch.float16)


def test_test_entry_point_needs_cuda_or_explicit_cpu(monkeypatch, tmp_path):
    from halo_tpu_torch import test
    from halo_tpu_torch.config import get_default_cfg
    from halo_tpu_torch.engine.learners import TestLearner, build_learner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = str(REPO / "configs" / "gtav" / "test.yaml")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        test.main(["-cfg", config, "MODEL.WEIGHTS", "", "resume", "",
                   "MODEL.NAME", "deeplabv3plus_resnettiny",
                   "OUTPUT_DIR", str(tmp_path)])
    cfg = get_default_cfg()
    cfg.MODEL.NAME = "deeplabv3plus_resnettiny"
    cfg.MODEL.WEIGHTS = ""
    cfg.PROTOCOL = "test"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_learner(cfg)
    assert isinstance(build_learner(cfg, device="cpu"), TestLearner)
