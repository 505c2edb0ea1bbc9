"""Port parity, the slice: acquisition round 0 of the tiny source_target
learner (tests/test_engine.py's tiny_cfg, float32 compute and scoring) in
both packages from the same weights. Equal stats, byte-identical mask
PNGs and equal indicators are expected; beside it, the port's selection
on the JAX package's own score map must be bit-exact."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from halo_tpu.active.region_selection import region_selection as jax_round
from halo_tpu.active.scoring import fused_upsample_region_score
from halo_tpu.active.selection import select_pixels_to_label
from halo_tpu.engine import build_learner
from halo_tpu.engine.steps import make_forward as jax_make_forward
from halo_tpu_torch.active.region_selection import region_selection
from halo_tpu_torch.active.selection import cuda_select_pixels_to_label
from halo_tpu_torch.config import get_default_cfg
from halo_tpu_torch.data import mask_cache
from halo_tpu_torch.data.build import build_active_loader
from halo_tpu_torch.data.catalog import DatasetCatalog
from halo_tpu_torch.data.masks import load_indicator
from halo_tpu_torch.models import build_segmentor, variables_to_state_dict
import pytest

from tests.conftest import build_mini_dataset
from tests.test_engine import tiny_cfg


def _files(root):
    out = {}
    for dirpath, _dirs, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            out[os.path.relpath(path, root)] = path
    return out


@pytest.fixture(scope="module")
def jax_learner(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("slice")
    root = build_mini_dataset(tmp_path / "datasets")
    cfg = tiny_cfg(root, tmp_path, "source_target")
    cfg.TPU.SCORING_DTYPE = "float32"
    return cfg, build_learner(cfg), tmp_path


def test_round_zero_matches_jax(jax_learner):
    cfg, learner, tmp_path = jax_learner
    variables = jax.tree_util.tree_map(np.asarray,
                                       learner.state.variables())
    want = jax_round(cfg, learner.model, learner.state,
                     learner.active_loader, 0, mesh=learner.mesh)

    pcfg = get_default_cfg()
    pcfg.set_new_allowed(True)
    pcfg.merge_from_other_cfg(cfg)
    pcfg.SAVE_DIR = str(tmp_path / "port")
    model = build_segmentor(pcfg, device="cpu")
    model.load_state_dict(variables_to_state_dict(variables), strict=True)
    mask_cache.clear()
    DatasetCatalog.init_mask(pcfg)
    got = region_selection(pcfg, model, build_active_loader(pcfg, 0), 0,
                           progress=False, device="cpu")
    assert got == want and got["picked"] > 0

    for kind in ("gtMask", "gtIndicator"):
        jfiles = _files(os.path.join(cfg.SAVE_DIR, kind))
        pfiles = _files(os.path.join(pcfg.SAVE_DIR, kind))
        assert jfiles.keys() == pfiles.keys() and len(jfiles) == 3
        for rel in jfiles:
            if kind == "gtMask":
                with open(jfiles[rel], "rb") as a, open(pfiles[rel],
                                                        "rb") as b:
                    assert a.read() == b.read(), rel
            else:
                a, b = load_indicator(jfiles[rel]), load_indicator(
                    pfiles[rel])
                assert a.keys() == b.keys()
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=rel)


def test_selection_on_the_jax_score_map(jax_learner):
    _cfg, learner, _tmp = jax_learner
    batch = next(iter(learner.active_loader))
    logits, embed = jax.jit(
        lambda v, x: jax_make_forward(learner.model)(v, x, False))(
            learner.state.variables(), jnp.asarray(batch["img"], jnp.float32))
    size = tuple(int(s) for s in batch["size"][0])
    score, _, _ = fused_upsample_region_score(
        logits[0], embed[0], size, score_dtype=jnp.float32)
    n = int(np.ceil(size[0] * size[1] * 0.01 / 9))
    kw = dict(num_picks=n, active_radius=1, mask_radius=2)
    fields = [np.asarray(batch[k][0]) for k in
              ("origin_mask", "origin_label", "active", "selected")]
    ref = select_pixels_to_label(score, *[jnp.asarray(f) for f in fields],
                                 **kw)
    got = cuda_select_pixels_to_label(
        torch.from_numpy(np.array(score)),
        *[torch.from_numpy(f.copy()) for f in fields], **kw)
    for field in ("picks", "active_mask", "active", "selected", "score"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(ref, field)),
                                      err_msg=field)
    assert int(got.num_picked) == int(ref.num_picked) == n
