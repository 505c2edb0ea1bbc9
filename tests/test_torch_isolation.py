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
                 "halo_tpu_torch.ops.prng",
                 "halo_tpu_torch.engine.learners",
                 "halo_tpu_torch.engine.state", "halo_tpu_torch.engine.steps",
                 "halo_tpu_torch.data.datasets",
                 "halo_tpu_torch.data.catalog",
                 "halo_tpu_torch.utils.visualize",
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
    with pytest.raises(ValueError):
        cuda_select.greedy_picks(torch.zeros((4, 4), device="meta"),
                                 num_picks=1, mask_radius=1)
    with pytest.raises(ValueError):
        cuda_radius.radius_map(torch.zeros((4, 4, 8), device="meta"))


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
