"""Port parity, the round's score stage: the interpolation tables of the
region-score kernel pair (``ops/resize.interp_table``), its plain version
(``active/cuda_score.region_score_plain``, the wrapper's CPU route) against
``halo_tpu.active.scoring.fused_upsample_region_score`` on the same seeded
inputs, and the dispatch of ``fused_upsample_region_score`` by type. The
kernel itself runs on the card only (``tests/test_torch_kernels.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo_tpu.active import scoring as js
from halo_tpu_torch.active import cuda_radius, cuda_score
from halo_tpu_torch.active import scoring as ts
from halo_tpu_torch.ops import resize as tr

TOL = dict(rtol=0, atol=1e-5)


def _ball(rng, shape, hi=0.9):
    """Points of the Poincare ball, radii uniform in [0, hi)."""
    x = rng.normal(size=shape)
    r = rng.uniform(0, hi, shape[:-1] + (1,))
    return (x / np.linalg.norm(x, axis=-1, keepdims=True) * r).astype(
        np.float32)


def _inputs(seed, logits_hw, embed_hw, classes=19, width=16):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=tuple(logits_hw) + (classes,)) * 3).astype(
        np.float32)
    return logits, _ball(rng, tuple(embed_hw) + (width,))


@pytest.mark.parametrize("out_size,in_size", [
    (1024, 640), (1024, 160), (2048, 1280), (2048, 320),  # Cityscapes
    (1080, 640), (1920, 1280), (1080, 160), (1920, 320),  # ACDC
    (300, 1), (1, 7), (96, 96), (260, 8)])
def test_tables_rebuild_interp_matrix(out_size, in_size):
    """w_lo placed at lo and w_hi added at hi give _interp_matrix exactly;
    lo and hi are neighbours."""
    t = tr.interp_table(out_size, in_size)
    assert t.shape == (4, out_size) and t.dtype == np.int32
    lo, hi = t[0], t[1]
    assert ((hi - lo >= 0) & (hi - lo <= 1)).all()
    m = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    np.add.at(m, (rows, lo), t[2].view(np.float32))
    np.add.at(m, (rows, hi), t[3].view(np.float32))
    np.testing.assert_array_equal(m, tr._interp_matrix(out_size, in_size))


def test_resize_by_table_matches_resize_bilinear():
    """The two-tap contraction is the banded einsum's resize, up to the
    einsum's rounding."""
    x = _ball(np.random.default_rng(1), (9, 13, 5))
    size = (130, 300)
    got = tr.resize_by_table(torch.from_numpy(x),
                             tr.device_table(size[0], 9, torch.device("cpu")),
                             tr.device_table(size[1], 13,
                                             torch.device("cpu")))
    want = tr.resize_bilinear(torch.from_numpy(x), size)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-6)


CASES = [  # (uncertainty, purity, native, logits (h, w), embedding (h, w))
    ("entropy", "radius", (260, 300), (8, 12), (4, 6)),
    ("pixel_entropy", "radius", (260, 300), (8, 12), (4, 6)),
    ("entropy", "hyper", (260, 300), (8, 12), (4, 6)),
    ("entropy", "radius", (20, 24), (20, 24), (20, 24)),
    ("entropy", "hyper", (20, 24), (20, 24), (10, 12)),
]


@pytest.mark.parametrize("unc,pur,native,lhw,ehw", CASES)
def test_plain_version_matches_jax_f32(unc, pur, native, lhw, ehw):
    """At score_dtype float32: a native size whose tiles are ragged and
    whose last 128-row block is short, and one equal to the input. The
    CPU route of ``fused_upsample_region_score`` is the pair's plain
    version (``region_score_plain`` for 'radius'; ``region_maps_plain``
    and the histogram tail for 'hyper')."""
    logits, embed = _inputs(2, lhw, ehw)
    opts = dict(unc_type=unc, pur_type=pur, size=3, K=10)
    got = ts.fused_upsample_region_score(
        torch.from_numpy(logits), torch.from_numpy(embed), native,
        score_dtype=torch.float32, **opts)
    want = js.fused_upsample_region_score(
        jnp.asarray(logits), jnp.asarray(embed), native,
        score_dtype=jnp.float32, num_classes=19, **opts)
    for g, w in zip(got, want):
        assert g.shape == native and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    if pur == "radius":
        plain = cuda_score.region_score_plain(
            torch.from_numpy(logits), torch.from_numpy(embed), native,
            score_dtype=torch.float32, halo=int(unc == "entropy"))
        for g, p in zip(got, plain):
            assert torch.equal(g, p)


@pytest.mark.parametrize("unc,pur", [("entropy", "radius"),
                                     ("pixel_entropy", "radius"),
                                     ("entropy", "hyper")])
def test_plain_version_matches_jax_bf16(unc, pur):
    """At score_dtype bf16 the upsampled float32 values are cast to bf16
    before the maps: a one-ulp float32 difference between the two packages'
    interpolation (the einsum's sum against two products and a sum) can
    cross a bf16 rounding boundary and move that pixel's maps by a bf16
    step, so the maps are held pixel by pixel: fewer than 1e-3 of the
    pixels differ by more than 1e-5."""
    logits, embed = _inputs(3, (8, 12), (4, 6))
    native = (260, 300)
    opts = dict(unc_type=unc, pur_type=pur, size=3, K=10)
    got = ts.fused_upsample_region_score(
        torch.from_numpy(logits), torch.from_numpy(embed), native,
        score_dtype=torch.bfloat16, **opts)
    want = js.fused_upsample_region_score(
        jnp.asarray(logits), jnp.asarray(embed), native,
        score_dtype=jnp.bfloat16, num_classes=19, **opts)
    for g, w in zip(got, want):
        off = np.abs(g.numpy() - np.asarray(w, np.float32)) > 1e-5
        assert off.mean() < 1e-3, off.mean()


def test_dispatch_table_names_every_type():
    """The recipes' types go to the kernel pair, the others to the block
    loop; a pair takes the kernel only when both of its types do."""
    assert set(ts.UNCERTAINTY_ROUTE) == {
        "entropy", "pixel_entropy", "oracle_acc", "none", "hyperbolic",
        "certainty"}
    assert set(ts.PURITY_ROUTE) == {"radius", "hyper", "ripu",
                                    "oracle_ripu", "euc_norm", "none"}
    for unc in ts.UNCERTAINTY_ROUTE:
        for pur in ts.PURITY_ROUTE:
            want = ("kernel" if unc in ("entropy", "pixel_entropy")
                    and pur in ("radius", "hyper") else "blocks")
            assert ts.score_route(unc, pur) == want, (unc, pur)
    assert ts.score_route("entropy", "unknown") == "blocks"


@pytest.mark.parametrize("unc,pur,route", [
    ("entropy", "radius", "kernel"), ("entropy", "hyper", "kernel"),
    ("pixel_entropy", "radius", "kernel"), ("entropy", "ripu", "blocks"),
    ("oracle_acc", "oracle_ripu", "blocks"), ("none", "euc_norm", "blocks"),
    ("entropy", "none", "blocks")])
def test_dispatch_on_cpu(unc, pur, route, monkeypatch):
    """On CPU tensors the kernel route is the plain version and launches
    nothing; the block route runs the loop (with kernel B's plain
    version for a radius)."""
    calls = []
    for name in ("region_score_plain", "region_maps_plain"):
        real = getattr(cuda_score, name)
        monkeypatch.setattr(cuda_score, name,
                            lambda *a, _real=real, _name=name, **k:
                            calls.append(_name) or _real(*a, **k))
    logits, embed = _inputs(4, (8, 12), (4, 6), classes=5)
    gt = np.random.default_rng(5).integers(0, 5, (40, 50)).astype(np.int32)
    cuda_score.launches = cuda_score.launches_s2 = 0
    cuda_radius.launches = 0
    out = ts.fused_upsample_region_score(
        torch.from_numpy(logits), torch.from_numpy(embed), (40, 50),
        torch.from_numpy(gt), score_dtype=torch.float32, unc_type=unc,
        pur_type=pur, num_classes=5, K=10)
    assert bool(calls) == (route == "kernel")
    if route == "kernel":
        assert calls[0] == ("region_score_plain" if pur == "radius"
                            else "region_maps_plain")
    assert cuda_score.launches == cuda_score.launches_s2 == 0
    assert cuda_radius.launches == 0
    want = ts.floating_region_score(
        tr.resize_bilinear(torch.from_numpy(logits), (40, 50)),
        tr.resize_bilinear(torch.from_numpy(embed), (40, 50)),
        torch.from_numpy(gt), unc_type=unc, pur_type=pur, num_classes=5,
        K=10)
    for g, w in zip(out, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


def test_refusals():
    """A device that is neither the CPU nor CUDA raises, as do an even
    window and a missing embedding; nothing launches."""
    logits, embed = _inputs(6, (8, 12), (4, 6))
    lg, em = torch.from_numpy(logits), torch.from_numpy(embed)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_score.region_score(lg.to("meta"), em.to("meta"), (16, 24))
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_score.region_maps(lg.to("meta"), em.to("meta"), (16, 24))
    with pytest.raises(ValueError, match="not odd"):
        ts.fused_upsample_region_score(lg, em, (16, 24), size=4)
    with pytest.raises(ValueError, match="needs an embedding"):
        cuda_score.region_score(lg, None, (16, 24))
    assert cuda_score.launches == cuda_score.launches_s2 == 0


def test_band_covers_every_tile():
    """S1's shared-memory bands hold every tile's input rows and columns,
    halo included, and the column stride is odd."""
    th, tw = cuda_score.TILE
    for out, inp, halo in ((2048, 1280, 1), (2048, 320, 0), (1920, 1280, 1),
                           (300, 12, 8), (24, 24, 1)):
        for tile in (th, tw):
            span = cuda_score._span(out, inp, tile, halo)
            t = tr.interp_table(out, inp)
            for x0 in range(0, out, tile):
                xl, xr = max(x0 - halo, 0), min(x0 + tile + halo, out) - 1
                assert t[1, xr] - t[0, xl] + 1 <= span
            assert (span | 1) % 2 == 1


@pytest.mark.parametrize("native,lhw,ehw,halo,classes,width", [
    ((1024, 2048), (640, 1280), (160, 320), 1, 19, 64),   # Cityscapes
    ((1080, 1920), (640, 1280), (160, 320), 1, 19, 64),   # ACDC
    ((760, 1280), (640, 1280), (160, 320), 1, 16, 64),    # SYNTHIA's classes
    ((1024, 2048), (640, 1280), (160, 320), 8, 19, 64),   # the widest window
    ((70, 130), (30, 50), (10, 17), 1, 16, 512),          # wide: chunks
    ((48, 70), (48, 70), (48, 70), 8, 19, 64),            # input = native
])
def test_plan_fits_three_blocks(native, lhw, ehw, halo, classes, width):
    """The plan's chunks cover the channels in at most one more chunk than
    needed, and its shared memory lets three blocks share a multiprocessor
    (228 KB, 1 KB reserved a block and S1's static tables) at the
    recipes' shapes, and one block at the others."""
    ck_l, ck_e, nbp_l, nbp_e, x_words, r_words, smem = cuda_score.plan(
        *native, lhw, ehw, classes, width, halo)
    th, tw = cuda_score.TILE
    assert 1 <= ck_l <= classes and 1 <= ck_e <= width
    assert nbp_l % 2 == 1 and nbp_e % 2 == 1
    assert smem == 4 * (2 * x_words + r_words
                        + (th + 2 * halo) * (tw + 2 * halo))
    blocks = 3 if lhw == (640, 1280) else 1
    assert blocks * (smem + 2048) <= 228 * 1024, smem
