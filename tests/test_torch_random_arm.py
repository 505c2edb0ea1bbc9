"""Port parity, the ``random`` control arm of the acquisition round
(``ACTIVE.UNCERTAINTY 'random'``): the port's threefry bits against
``jax.random.uniform`` bit for bit, and a round over the mini dataset in
both packages giving equal stats, byte-identical mask PNGs and equal
indicators, with no forward in the port."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from halo_tpu.active.region_selection import region_selection as jax_round
from halo_tpu.engine import build_learner
from halo_tpu_torch.active.region_selection import (random_arm_seed,
                                                    region_selection)
from halo_tpu_torch.config import get_default_cfg
from halo_tpu_torch.data import mask_cache
from halo_tpu_torch.data.build import build_active_loader
from halo_tpu_torch.data.catalog import DatasetCatalog
from halo_tpu_torch.data.masks import load_indicator
from halo_tpu_torch.ops import prng
from tests.conftest import build_mini_dataset
from tests.test_engine import tiny_cfg
from tests.test_torch_slice import _files


def _jax_uniform(seed, shape):
    key = jax.random.PRNGKey(np.uint32(seed))
    return np.asarray(jax.random.uniform(key, shape, jnp.float32))


@pytest.mark.parametrize("seed,shape", [
    (0, (4, 5)), (1, (37, 53)), (12345, (37, 53)), (2 ** 31 - 1, (1, 7)),
    (random_arm_seed(3, 2, 17), (64, 128)), (987654321, (1024, 2048))])
def test_uniform_bits_match_jax(seed, shape):
    want = _jax_uniform(seed, shape)
    got = prng.uniform(seed, shape).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got.min() >= 0.0 and got.max() < 1.0


def test_random_round_matches_jax(tmp_path):
    """Three images in batches of two (the JAX loader pads the last one):
    the per-image seeds follow the image's index in the sweep."""
    root = build_mini_dataset(tmp_path / "datasets")
    cfg = tiny_cfg(root, tmp_path, "source_target")
    cfg.ACTIVE.UNCERTAINTY = "random"
    cfg.TPU.ACTIVE_BATCH = 2
    cfg.SEED = 5
    learner = build_learner(cfg)
    want = jax_round(cfg, learner.model, learner.state,
                     learner.active_loader, 2, mesh=learner.mesh)

    pcfg = get_default_cfg()
    pcfg.set_new_allowed(True)
    pcfg.merge_from_other_cfg(cfg)
    pcfg.SAVE_DIR = str(tmp_path / "port")
    mask_cache.clear()
    DatasetCatalog.init_mask(pcfg)
    # no model: the arm runs no forward
    got = region_selection(pcfg, None, build_active_loader(pcfg, 0), 2,
                           progress=False, device="cpu")
    assert got == want and got["images"] == 3 and got["picked"] > 0

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
    # the round is seeded: a different SEED picks other pixels
    pcfg.SEED = 6
    pcfg.SAVE_DIR = str(tmp_path / "port6")
    mask_cache.clear()
    DatasetCatalog.init_mask(pcfg)
    region_selection(pcfg, None, build_active_loader(pcfg, 0), 2,
                     progress=False, device="cpu")
    rel = sorted(_files(os.path.join(pcfg.SAVE_DIR, "gtIndicator")))[0]
    a = load_indicator(os.path.join(pcfg.SAVE_DIR, "gtIndicator", rel))
    b = load_indicator(os.path.join(tmp_path / "port", "gtIndicator", rel))
    assert not np.array_equal(a["selected"], b["selected"])


def test_random_round_on_two_sizes_matches_jax(tmp_path):
    """A target set of two native sizes (three 32x64 images, then two
    40x72) at ``TPU.ACTIVE_BATCH`` 2: the JAX sweep batches by size and
    pads the 32x64 bucket's last batch, so the 40x72 images are images 4
    and 5 of its sweep; the port's masks, seeded by the same index, are
    the JAX package's."""
    from tests.conftest import add_mixed_size_images

    root = build_mini_dataset(tmp_path / "datasets")
    add_mixed_size_images(root)
    cfg = tiny_cfg(root, tmp_path, "source_target")
    cfg.ACTIVE.UNCERTAINTY = "random"
    cfg.TPU.ACTIVE_BATCH = 2
    cfg.SEED = 5
    learner = build_learner(cfg)
    want = jax_round(cfg, learner.model, learner.state,
                     learner.active_loader, 1, mesh=learner.mesh)

    pcfg = get_default_cfg()
    pcfg.set_new_allowed(True)
    pcfg.merge_from_other_cfg(cfg)
    pcfg.SAVE_DIR = str(tmp_path / "port")
    mask_cache.clear()
    DatasetCatalog.init_mask(pcfg)
    loader = build_active_loader(pcfg, 0)
    assert [len(b["size"]) for b in loader] == [2, 1, 2]
    got = region_selection(pcfg, None, loader, 1, progress=False,
                           device="cpu")
    assert got == want and got["images"] == 5

    jfiles = _files(os.path.join(cfg.SAVE_DIR, "gtMask"))
    pfiles = _files(os.path.join(pcfg.SAVE_DIR, "gtMask"))
    assert jfiles.keys() == pfiles.keys() and len(jfiles) == 5
    for rel in jfiles:
        with open(jfiles[rel], "rb") as a, open(pfiles[rel], "rb") as b:
            assert a.read() == b.read(), rel
    for rel, path in _files(os.path.join(cfg.SAVE_DIR,
                                         "gtIndicator")).items():
        a = load_indicator(path)
        b = load_indicator(os.path.join(pcfg.SAVE_DIR, "gtIndicator", rel))
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=rel)
