"""CUDA kernels against their plain versions, on the card (marker
``cuda``; skipped without a GPU). Imports no JAX, so it also runs where
JAX is absent:

    python -m pytest --noconftest tests/test_torch_kernels.py
"""

import math

import pytest
import torch

from halo_tpu_torch.active import cuda_radius, cuda_score, cuda_select
from halo_tpu_torch.active import selection as tsel

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.Generator(device="cuda").manual_seed(0)


def _ball(shape, gen, dtype):
    x = torch.randn(shape, generator=gen, device="cuda")
    r = 0.3 + 0.6 * torch.rand(shape[:-1] + (1,), generator=gen,
                               device="cuda")
    return (x / x.norm(dim=-1, keepdim=True) * r).to(dtype)


@pytest.mark.parametrize("shape,dtype", [
    ((3, 5, 64), torch.bfloat16),     # 16-byte loads, 8 chunks a pixel
    ((7, 13, 24), torch.bfloat16),    # 3 chunks: lanes idle
    ((5, 9, 20), torch.bfloat16),     # C % 8 != 0: scalar loop
    ((4, 6, 64), torch.float32),
    ((1, 1, 8), torch.bfloat16),      # fewer pixels than a block
])
def test_radius_matches_plain(gen, shape, dtype):
    x = _ball(shape, gen, dtype)
    before = cuda_radius.launches
    got = cuda_radius.radius_map(x)
    want = cuda_radius.radius_map_reference(x)
    assert cuda_radius.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


def _score_inputs(gen, lhw, ehw, classes=19, width=64, ldtype=torch.float32,
                  nchw=False):
    """Logits (h, w, classes) and a float32 ball embedding (h2, w2, width);
    with ``nchw`` both are channel-last views of NCHW buffers, as an
    elementwise op on a permuted head output leaves them."""
    lg = (torch.randn((1, classes) + tuple(lhw), generator=gen,
                      device="cuda") * 3.0).to(ldtype)
    em = torch.randn((1, width) + tuple(ehw), generator=gen, device="cuda")
    r = 0.95 * torch.rand((1, 1) + tuple(ehw), generator=gen, device="cuda")
    em = em / em.norm(dim=1, keepdim=True) * r
    lg, em = lg[0].permute(1, 2, 0), em[0].permute(1, 2, 0)
    if not nchw:
        lg, em = lg.contiguous(), em.contiguous()
    return lg, em


@pytest.mark.parametrize("native,lhw,ehw,kw", [
    ((64, 128), (40, 80), (10, 20), {}),                  # one row of tiles
    ((100, 150), (37, 61), (11, 17), {}),                 # ragged tiles
    ((100, 150), (37, 61), (11, 17), {"score_dtype": torch.float32}),
    ((48, 70), (48, 70), (48, 70), {}),                   # input = native
    ((33, 65), (1, 7), (2, 3), {}),                       # in_size 1
    ((80, 96), (20, 24), (5, 6), {"halo": 2}),            # window 5x5
    ((80, 96), (20, 24), (5, 6), {"halo": 8}),            # the largest
    ((80, 96), (20, 24), (5, 6), {"halo": 0}),            # pixel_entropy
    ((80, 96), (20, 24), (5, 6), {"normalize": False}),
    ((80, 96), (20, 24), (5, 6), {"maps": True}),         # S1 alone
    ((80, 96), (20, 24), (5, 6), {"c": 2.0}),
])
def test_region_score_matches_plain(gen, native, lhw, ehw, kw):
    """S1 + S2 (``region_score``) or S1 alone (``region_maps``) against
    their plain version: the maps within 1e-5, S1 once and S2 once a
    ``region_score`` call."""
    kw = dict(kw)
    maps = kw.pop("maps", False)
    lg, em = _score_inputs(gen, lhw, ehw)
    em = em / math.sqrt(kw.get("c", 1.0))  # inside the ball of radius 1/sqrt c
    s1, s2 = cuda_score.launches, cuda_score.launches_s2
    if maps:
        got = cuda_score.region_maps(lg, em, native, **kw)
        want = cuda_score.region_maps_plain(lg, em, native, **kw)
    else:
        got = cuda_score.region_score(lg, em, native, **kw)
        want = cuda_score.region_score_plain(lg, em, native, **kw)
    torch.cuda.synchronize()
    assert cuda_score.launches == s1 + 1
    assert cuda_score.launches_s2 == s2 + (not maps)
    for g, w in zip(got, want):
        assert g.shape == native and torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5)


def test_region_score_hyper_routes_s1(gen):
    """Purity 'hyper' through the scorer: S1 alone (its raw maps finished
    by the histogram tail in torch), against the CPU route."""
    from halo_tpu_torch.active.scoring import fused_upsample_region_score
    lg, em = _score_inputs(gen, (20, 24), (5, 6))
    s1, s2 = cuda_score.launches, cuda_score.launches_s2
    kw = dict(pur_type="hyper", K=10, score_dtype=torch.float32)
    got = fused_upsample_region_score(lg, em, (80, 96), **kw)
    torch.cuda.synchronize()
    assert (cuda_score.launches, cuda_score.launches_s2) == (s1 + 1, s2)
    unc, rad = cuda_score.region_maps(lg, em, (80, 96),
                                      score_dtype=torch.float32)
    unc_p, rad_p = cuda_score.region_maps_plain(lg, em, (80, 96),
                                                score_dtype=torch.float32)
    torch.testing.assert_close(unc, unc_p, rtol=0, atol=1e-5)
    torch.testing.assert_close(rad, rad_p, rtol=0, atol=1e-5)
    assert all(g.shape == (80, 96) and torch.isfinite(g).all() for g in got)


@pytest.mark.parametrize("ldtype,nchw,classes,width", [
    (torch.bfloat16, False, 19, 64),   # a Euclidean head's bf16 logits
    (torch.float32, True, 19, 64),     # channel-last views of NCHW
    (torch.float32, False, 16, 512),   # SYNTHIA's classes, wide: chunks
    (torch.bfloat16, True, 5, 3),
])
def test_region_score_layouts(gen, ldtype, nchw, classes, width):
    lg, em = _score_inputs(gen, (30, 50), (10, 17), classes, width, ldtype,
                           nchw)
    got = cuda_score.region_score(lg, em, (70, 130))
    want = cuda_score.region_score_plain(lg, em, (70, 130))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5)


def test_region_score_raw_maps(gen):
    """The kernel's own entropy (pixel_entropy, not normalised) within 2e-6
    relative to the larger of itself and log(sum e^v) / log 19 (a
    near-certain pixel's small entropy is cancelled from a large log s, so
    the order of the channel sums moves it by more than 2e-6 of itself)
    and its radius in t = tanh(r/2) within 1e-6, bf16 and float32 score
    dtype; two calls give the same bits."""
    from halo_tpu_torch.ops.resize import device_table, resize_by_table
    lg, em = _score_inputs(gen, (64, 128), (16, 32))
    for dtype in (torch.bfloat16, torch.float32):
        kw = dict(score_dtype=dtype, halo=0)
        ent, rad = cuda_score.region_maps(lg, em, (103, 205), **kw)
        ent_p, rad_p = cuda_score.region_maps_plain(lg, em, (103, 205),
                                                    **kw)
        up = resize_by_table(lg, device_table(103, 64, lg.device),
                             device_table(205, 128, lg.device))
        lse = torch.logsumexp(up.to(dtype).float().clamp(-60, 60), -1)
        scale = torch.maximum(ent_p.abs(), lse.abs() / math.log(19.0))
        assert float(((ent - ent_p).abs() / scale).max()) <= 2e-6
        torch.testing.assert_close(torch.tanh(rad / 2),
                                   torch.tanh(rad_p / 2), rtol=0, atol=1e-6)
        again = cuda_score.region_maps(lg, em, (103, 205), **kw)
        assert torch.equal(again[0], ent) and torch.equal(again[1], rad)


def test_region_score_refuses(gen):
    lg, em = _score_inputs(gen, (8, 8), (4, 4))
    with pytest.raises(ValueError, match="outside the kernel"):
        cuda_score.region_score(lg, em, (16, 16), halo=9)
    with pytest.raises(ValueError, match="shared memory"):  # 8x downsample
        cuda_score.region_score(lg.repeat(32, 32, 1), em, (16, 16))
    with pytest.raises(ValueError, match="needs an embedding"):
        cuda_score.region_score(lg, None, (16, 16))
    with pytest.raises(TypeError, match="score dtype"):
        cuda_score.region_score(lg, em, (16, 16), score_dtype=torch.half)
    with pytest.raises(ValueError, match="empty"):
        cuda_score.region_score(lg, em, (0, 16))


@pytest.mark.parametrize("h,w", [(80, 160), (160, 320)])
def test_radius_f32_on_flip_averaged_embedding(gen, h, w):
    """The rich eval's call: the f32 instantiation on a flip-averaged
    (1, h, w, 64) embedding, through the scorer's entry, one launch; at a
    640x1280 input the decoder's embedding is (1, 160, 320, 64)."""
    from halo_tpu_torch.active.scoring import _radius_map
    e = _ball((2, h, w, 64), gen, torch.float32)
    x = (e[:1] + e[1:].flip(2)) / 2.0
    before = cuda_radius.launches
    got = _radius_map(x, 1.0)
    assert cuda_radius.launches == before + 1 and got.shape == (1, h, w)
    torch.testing.assert_close(got, cuda_radius.radius_map_reference(x),
                               rtol=1e-6, atol=0)


def test_radius_unaligned_view(gen):
    buf = _ball((9, 24), gen, torch.bfloat16).reshape(-1)
    x = buf[3:3 + 8 * 24].view(8, 24)  # 6-byte offset: scalar loads
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    torch.testing.assert_close(cuda_radius.radius_map(x),
                               cuda_radius.radius_map_reference(x),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("h,w,n,m", [
    (64, 96, 40, 3),
    (5, 40, 12, 2),        # fewer rows than a warp
    (16, 7000, 30, 5),     # > 48 KB of column cache
    (33, 50, 25, 0),       # m = 0: single-pixel suppression
])
def test_greedy_picks_bit_exact(gen, h, w, n, m):
    score = torch.randn((h, w), generator=gen, device="cuda")
    score[: h // 4, : w // 4] = float("-inf")
    score[h // 2: h // 2 + 3, w // 3: w // 3 + 4] = 3.0  # ties
    before = cuda_select.launches
    got = cuda_select.greedy_picks(score, num_picks=n, mask_radius=m)
    want = cuda_select.greedy_picks_reference(score, num_picks=n,
                                              mask_radius=m)
    assert cuda_select.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_greedy_picks_runs_out(gen):
    score = torch.full((20, 30), float("-inf"), device="cuda")
    score[3, 4], score[15, 25], score[15, 27] = 1.0, 2.0, 2.0
    picks, n = cuda_select.greedy_picks(score, num_picks=8, mask_radius=2)
    assert int(n) == 2
    assert picks[:2].tolist() == [[15, 25], [3, 4]]
    assert (picks[2:] == -1).all()


def test_greedy_picks_segments_and_edges(gen):
    """A 1000x2048 map caches 128-row segments (1000 is not a multiple);
    m = 130 >= 128, so a window spans three or four segments; the top
    scores sit on the four edges and corners."""
    h, w, m = 1000, 2048, 130
    score = torch.randn((h, w), generator=gen, device="cuda")
    edges = [(0, 0), (500, 0), (h - 1, 0), (0, 900), (h - 1, 1500),
             (0, w - 1), (400, w - 1), (h - 1, w - 1)]  # in pick order
    for r, c in edges:
        score[r, c] = 10.0
    got = cuda_select.greedy_picks(score, num_picks=40, mask_radius=m)
    want = cuda_select.greedy_picks_reference(score, num_picks=40,
                                              mask_radius=m)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[0][:len(edges)].tolist() == [list(e) for e in edges]


def test_greedy_picks_batch_is_one_launch(gen):
    """Four maps in one launch, each bit-exact with the plain version on
    its own: random, a pre-active block, an early stop after 2 picks, a
    tie plateau."""
    maps = torch.randn((4, 200, 300), generator=gen, device="cuda")
    maps[1, :50, :80] = float("-inf")
    maps[2] = float("-inf")
    maps[2, 10, 20], maps[2, 150, 250] = 1.0, 2.0
    maps[3, 60:70, 100:130] = 5.0
    before = cuda_select.launches
    picks, counts = cuda_select.greedy_picks(maps, num_picks=50,
                                             mask_radius=4)
    assert cuda_select.launches == before + 1
    assert picks.shape == (4, 50, 2) and counts.shape == (4,)
    for i in range(4):
        want = cuda_select.greedy_picks_reference(maps[i], num_picks=50,
                                                  mask_radius=4)
        assert torch.equal(picks[i], want[0]), i
        assert int(counts[i]) == int(want[1]), i
    assert int(counts[2]) == 2 and (picks[2, 2:] == -1).all()


def test_select_batch_matches_plain_twin(gen):
    n, h, w = 3, 48, 80
    score = torch.randn((n, h, w), generator=gen, device="cuda")
    gt = torch.randint(0, 19, (n, h, w), generator=gen, device="cuda",
                       dtype=torch.int32)
    am = torch.full((n, h, w), 255, dtype=torch.int32, device="cuda")
    active = torch.zeros((n, h, w), dtype=torch.bool, device="cuda")
    active[0, :5, :9] = True
    active[2, 20:, 40:] = True
    selected = active.clone()
    kw = dict(num_picks=math.ceil(h * w * 0.05 / 9), active_radius=1,
              mask_radius=5)
    got = tsel.cuda_select_pixels_to_label_batch(score, am, gt, active,
                                                 selected, **kw)
    for i in range(n):
        want = tsel.select_pixels_to_label(score[i], am[i], gt[i],
                                           active[i], selected[i], **kw)
        for a, b in zip(got[i], want):
            assert torch.equal(a, b), i


def test_select_pixels_matches_plain_twin(gen):
    h, w = 48, 80
    score = torch.randn((h, w), generator=gen, device="cuda")
    gt = torch.randint(0, 19, (h, w), generator=gen, device="cuda",
                       dtype=torch.int32)
    am = torch.full((h, w), 255, dtype=torch.int32, device="cuda")
    active = torch.zeros((h, w), dtype=torch.bool, device="cuda")
    active[:5, :9] = True
    selected = torch.zeros_like(active)
    n = math.ceil(h * w * 0.05 / 9)
    kw = dict(num_picks=n, active_radius=1, mask_radius=5)
    got = tsel.cuda_select_pixels_to_label(score, am, gt, active, selected,
                                           **kw)
    want = tsel.select_pixels_to_label(score, am, gt, active, selected, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Kernel C: the dilated 3x3 conv, forward, dx and dk
# ---------------------------------------------------------------------------

def _bf16_steps(got, want, floor):
    """Largest |got - want| in units of one bf16 step of the larger
    magnitude, after forgiving ``floor`` (absolute): near zero the order of
    the float32 sums decides the rounding."""
    got, want = got.float(), want.float()
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(2.0 ** -126)
    step = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float((((got - want).abs() - floor).clamp_min(0) / step).max())


def _conv_case(gen, b, c, co, h, w, dtype):
    x = torch.randn((b, c, h, w), generator=gen, device="cuda").to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    wt = (torch.randn((co, c, 3, 3), generator=gen, device="cuda")
          / math.sqrt(9 * c)).to(dtype)
    g = torch.randn((b, co, h, w), generator=gen, device="cuda").to(dtype)
    return x, wt, g.contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("b,c,co,h,w,d,dtype", [
    (2, 128, 128, 16, 32, 1, torch.bfloat16),
    (2, 128, 128, 16, 32, 2, torch.bfloat16),
    (2, 128, 128, 16, 32, 4, torch.bfloat16),
    (2, 128, 256, 16, 32, 2, torch.bfloat16),    # Cin != Cout
    (1, 64, 160, 7, 13, 3, torch.bfloat16),      # ragged tiles
    (1, 32, 32, 5, 9, 1, torch.bfloat16),        # C < 64; H, W < a tile
    (1, 32, 160, 11, 37, 2, torch.bfloat16),     # C < 64, Co = 160
    (1, 96, 160, 13, 45, 4, torch.bfloat16),     # a partial 64-channel step
    (1, 160, 96, 6, 70, 2, torch.bfloat16),      # Co: one full, one ragged
    (1, 64, 256, 40, 320, 1, torch.bfloat16),    # 100 tiles: < 132 SMs
    (2, 64, 512, 64, 96, 1, torch.bfloat16),     # 192 tiles: 60 as halves
    (2, 256, 256, 90, 160, 2, torch.bfloat16),   # layer3, source
    (2, 512, 512, 80, 160, 4, torch.bfloat16),   # layer4, target
    (2, 128, 256, 16, 32, 2, torch.float32),
    (1, 48, 32, 9, 11, 2, torch.float32),        # ragged tiles, Cin != Cout
    # the float32 tile is 128 pixels x 128 output channels
    (1, 48, 16, 9, 11, 2, torch.float32),        # Co = 16
    (1, 16, 48, 13, 7, 3, torch.float32),        # Co = 48, C = 16
    (2, 144, 272, 10, 30, 1, torch.float32),     # M = 600, Co = 2*128 + 16
    (1, 256, 128, 45, 37, 4, torch.float32),     # M = 1665: a ragged tile
])
def test_dilated_conv_matches_plain(gen, b, c, co, h, w, d, dtype):
    from halo_tpu_torch.ops import dilated_conv as dc
    x, wt, g = _conv_case(gen, b, c, co, h, w, dtype)
    xk = x.clone().requires_grad_(True)
    wk = wt.clone().requires_grad_(True)
    before = (dc.launches_fwd, dc.launches_dx, dc.launches_dk)
    got = dc.dilated_conv3x3(xk, wk, d)
    got.backward(g)
    # dk is the weight-gradient kernel in bf16 and wgrad_taps in float32
    dk_launches = 1 if dtype == torch.bfloat16 else 0
    assert (dc.launches_fwd, dc.launches_dx, dc.launches_dk) == (
        before[0] + 1, before[1] + 1, before[2] + dk_launches)
    assert got.is_contiguous(memory_format=torch.channels_last)
    xp = x.clone().requires_grad_(True)
    wp = wt.clone().requires_grad_(True)
    want = dc.dilated_conv3x3_plain(xp, wp, d)
    want.backward(g)
    torch.cuda.synchronize()
    for a, e in ((got, want), (xk.grad, xp.grad), (wk.grad, wp.grad)):
        assert a.dtype == e.dtype == dtype
        floor = 1e-5 * float(e.detach().float().abs().max())
        if dtype == torch.bfloat16:
            assert _bf16_steps(a, e, floor) <= 1.0
        else:
            assert float((a - e).abs().max()) <= floor


def test_dilated_conv_weight_layout_gives_same_bits(gen):
    """The bf16 forward on the channels_last weight the models hold and on
    a contiguous one: both repacked to (9, Co, C), the same bits."""
    from halo_tpu_torch.ops import dilated_conv as dc
    x, wt, _ = _conv_case(gen, 2, 256, 160, 20, 45, torch.bfloat16)
    cl = wt.contiguous(memory_format=torch.channels_last)
    a = dc.dilated_conv3x3(x, wt, 2)
    b = dc.dilated_conv3x3(x, cl, 2)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize("b,c,co,h,w,d", [
    (1, 64, 96, 7, 13, 3),        # ragged pixel steps (32 x 2), C != Co
    (1, 32, 64, 9, 37, 1),        # C < 64: a box past C, all zeros
    (2, 96, 160, 13, 45, 4),      # a partial 64-channel box each way
    (1, 160, 96, 6, 70, 2),       # C across two 128-channel tiles
    (2, 128, 512, 16, 40, 2),     # two 256-channel tiles of Co
    (1, 32, 32, 3, 5, 1),         # 2 pixel steps: fewer units than SMs
    (1, 64, 64, 1, 1, 1),         # one pixel
    (1, 64, 32, 5, 9, 8),         # d beyond H and W: only the centre tap
    (2, 256, 256, 90, 160, 2),    # layer3 of the recipe
    (2, 512, 512, 90, 160, 2),    # layer4
    (2, 512, 512, 90, 160, 4),
    (2, 256, 256, 80, 160, 2),    # layer3, the target's 80x160
    (2, 512, 512, 80, 160, 4),    # layer4, the target
    (2, 160, 96, 40, 96, 2),      # C = 160, Co = 96: 18 ragged tiles
    (1, 32, 64, 4, 40, 1),        # 5 pixel steps a tile: one block each
    (1, 96, 64, 9, 23, 5),        # d = 5: steps of 8 x 8, an 8 x 18 x box
    (1, 32, 64, 20, 70, 16),      # d = 16: steps of 1 x 64, a 1 x 96 box
    (1, 64, 96, 12, 50, 9),       # d = 9: three 2 x 32 x boxes a step
    (1, 1024, 1024, 8, 64, 1),    # 288 tiles, whole, two or three a block
])
def test_dilated_conv_wgrad_matches_plain(gen, b, c, co, h, w, d):
    """The weight-gradient kernel against wgrad_taps on float32 operands
    (the sums it rounds once to bf16): one bf16 step beyond 1e-5 of
    max|dk|; two calls give the same bits."""
    from halo_tpu_torch.ops import dilated_conv as dc
    x, _, g = _conv_case(gen, b, c, co, h, w, torch.bfloat16)
    xh, gh = dc._nhwc(x), dc._nhwc(g)
    got = dc._wgrad(xh, gh, d)
    again = dc._wgrad(xh, gh, d)
    want = dc.wgrad_taps(x.float(), g.float(), d)
    torch.cuda.synchronize()
    assert got.shape == (co, c, 3, 3) and got.dtype == torch.bfloat16
    assert got.is_contiguous()
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))
    floor = 1e-5 * float(want.abs().max())
    assert _bf16_steps(got, want, floor) <= 1.0


@pytest.mark.parametrize("b,c,co,h,w,period,grid", [
    (2, 160, 96, 40, 96, 14, 100),   # 126 units on 100 blocks: ranges
                                     # across tiles, a last block going on
    (2, 160, 96, 40, 96, 3, 4),      # partial, whole and partial tiles
    (2, 160, 96, 40, 96, 1, 4),      # whole tiles only, 2 or 3 a block
    (1, 32, 64, 4, 40, 3, 9),        # as many residues as pixel steps
    (2, 512, 512, 80, 160, 11, 132),  # layer4 at the target's 80x160
])
def test_dilated_conv_wgrad_any_plan(gen, b, c, co, h, w, period, grid):
    """The kernel follows any plan the C entry takes (the period at most
    the pixel steps, the grid at most the SMs and the units): each against
    wgrad_taps, two calls the same bits."""
    from halo_tpu_torch.ops import dilated_conv as dc
    x, _, g = _conv_case(gen, b, c, co, h, w, torch.bfloat16)
    xh, gh = dc._nhwc(x), dc._nhwc(g)
    plan = dc.wgrad_plan(b, h, w, c, co, 2, 132)._replace(period=period,
                                                          grid=grid)
    got = dc._wgrad(xh, gh, 2, plan)
    again = dc._wgrad(xh, gh, 2, plan)
    want = dc.wgrad_taps(x.float(), g.float(), 2)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))
    assert _bf16_steps(got, want, 1e-5 * float(want.abs().max())) <= 1.0


def test_dilated_conv_wgrad_carries_nothing_between_calls(gen):
    """dk at one shape, at another (other tiles, other counts on the same
    counters), then at the first again: the first result's bits."""
    from halo_tpu_torch.ops import dilated_conv as dc
    x, _, g = _conv_case(gen, 2, 256, 256, 80, 160, torch.bfloat16)
    y, _, h = _conv_case(gen, 2, 512, 512, 40, 96, torch.bfloat16)
    xh, gh, yh, hh = dc._nhwc(x), dc._nhwc(g), dc._nhwc(y), dc._nhwc(h)
    first = dc._wgrad(xh, gh, 2)
    other = dc._wgrad(yh, hh, 4)
    again = dc._wgrad(xh, gh, 2)
    want = dc.wgrad_taps(y.float(), h.float(), 4)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int16), again.view(torch.int16))
    assert _bf16_steps(other, want, 1e-5 * float(want.abs().max())) <= 1.0


def test_dilated_conv_refuses(gen):
    from halo_tpu_torch import kernels
    from halo_tpu_torch.ops import dilated_conv as dc
    x = torch.zeros((1, 24, 8, 8), device="cuda", dtype=torch.bfloat16)
    wt = torch.zeros((32, 24, 3, 3), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):   # C % 32 != 0: the wrapper refuses
        dc.dilated_conv3x3(x, wt, 2)
    # Co % 16 != 0 in float32: the forward alone could run, but its dx (C
    # and Co swapped) could not, so the wrapper refuses the forward
    xf = torch.zeros((1, 48, 9, 11), device="cuda", requires_grad=True)
    wf = torch.zeros((40, 48, 3, 3), device="cuda", requires_grad=True)
    fwd = dc.launches_fwd
    with pytest.raises(ValueError):
        dc.dilated_conv3x3(xf, wf, 2)
    assert dc.launches_fwd == fwd
    y = torch.empty((1, 8, 8, 32), device="cuda", dtype=torch.bfloat16)
    lib = kernels.load()
    for c, co in ((24, 32), (32, 24)):  # the C entry refuses either way
        err = lib.halo_dilated_conv3x3_bf16(
            x.data_ptr(), wt.data_ptr(), y.data_ptr(), 1, 8, 8, c, co, 2,
            kernels.current_stream(x.device))
        with pytest.raises(RuntimeError, match="CUDA error"):
            kernels.check(err, "halo_dilated_conv3x3_bf16")
        assert lib.halo_dilated_conv3x3_wgrad_workspace(1, 8, 8, c, co,
                                                        2, 1, 1) == -1
    # the weight-gradient kernel refuses a plan it cannot follow: more
    # residues than pixel steps (8 x 8 at d = 2 is 2 steps of 4 x 16),
    # more blocks than SMs or units (3 tiles x 1), none
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    for period, grid in ((3, 3), (1, sms + 1), (1, 4), (1, 0), (0, 1)):
        assert lib.halo_dilated_conv3x3_wgrad_workspace(
            1, 8, 8, 32, 32, 2, period, grid) == -1
    assert lib.halo_dilated_conv3x3_wgrad_workspace(1, 8, 8, 32, 32, 2, 2,
                                                    6) > 0
    xg = torch.zeros((1, 8, 8, 32), device="cuda", dtype=torch.bfloat16)
    plan = dc.wgrad_plan(1, 8, 8, 32, 32, 2, sms)._replace(period=3)
    with pytest.raises(ValueError, match="refuses"):
        dc._wgrad(xg, xg, 2, plan)


def _int8_case(gen, b, c, co, h, w, k=1):
    """int8 activations as kernel Q writes them (NHWC, channels padded with
    zeros to a multiple of 16), int8 weights over the full range and their
    packed operand, float32 weight scales and an absmax on the device."""
    from halo_tpu_torch.ops import quant
    xq = torch.randint(-127, 128, (b, h, w, c), generator=gen,
                       device="cuda", dtype=torch.int8)
    xq = torch.nn.functional.pad(xq, (0, -c % 16)).contiguous()
    wq = torch.randint(-127, 128, (co, c, k, k), generator=gen,
                       device="cuda", dtype=torch.int8)
    w_scale = torch.rand((co,), generator=gen, device="cuda") * 1e-2
    amax = torch.rand((), generator=gen, device="cuda") * 4
    return xq, wq, quant.pack_weight(wq), w_scale, amax


def _scale(amax, w_scale):
    from halo_tpu_torch.ops import quant
    return quant.quantize_act(torch.zeros(1, device="cuda"), amax)[1] * \
        w_scale


@pytest.mark.parametrize("b,c,co,h,w,k,s,p,d", [
    (1, 64, 64, 40, 80, 3, 1, 1, 1),       # layer1: 64-byte K steps
    (2, 128, 128, 40, 80, 3, 2, 1, 1),     # layer2's first: stride 2
    (2, 256, 256, 20, 40, 3, 1, 2, 2),     # layer3
    (1, 512, 512, 20, 40, 3, 1, 4, 4),     # layer4
    (1, 2560, 512, 10, 20, 3, 1, 1, 1),    # the ASPP bottleneck
    (1, 128, 320, 21, 41, 3, 2, 1, 1),     # MiT pe3, odd H and W
    (1, 48, 40, 9, 11, 3, 1, 1, 1),        # C, Co no multiple of a tile
    (1, 20, 70, 7, 13, 3, 1, 2, 2),        # C % 16 != 0: padded channels
    (1, 32, 33, 5, 9, 1, 1, 1, 1),         # 1x1 with padding, odd Co
    (2, 64, 96, 13, 17, 5, 2, 3, 2),       # 5x5, stride 2, dilation 2
    (1, 16, 16, 1, 1, 3, 1, 1, 1),         # one pixel
    (1, 64, 64, 5, 7, 3, 1, 8, 8),         # d beyond H and W
])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_int8_conv_kernel_matches_plain_bit_for_bit(gen, b, c, co, h, w, k,
                                                    s, p, d, out_dtype):
    """Kernel I against its plain version (float64 sums of the int8
    values, exact), the same bits in float32 and in bfloat16."""
    from halo_tpu_torch.ops import quant
    xq, wq, packed, w_scale, amax = _int8_case(gen, b, c, co, h, w, k)
    before = quant.launches
    got = quant.int8_conv_kernel(xq, packed, w_scale, amax, k, s, p, d,
                                 out_dtype)
    want = quant.int8_conv_plain(xq[..., :c].permute(0, 3, 1, 2), wq,
                                 _scale(amax, w_scale), s, p, d, out_dtype)
    torch.cuda.synchronize()
    assert quant.launches == before + 1
    assert got.shape == want.shape and got.dtype == out_dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)


# The shapes of the int8 path as chip_smoke.py times them (R101 at a
# 640x1280 input, MiT-B4's pe3): (Cin, Cout, H, W, kernel, stride,
# dilation) of the k x k convs, and (M at B = 2, K, N) of the 1x1 convs
# and dense layers.
PATH_CONVS = {
    "layer1": (64, 64, 160, 320, 3, 1, 1),
    "layer2.0-s2": (128, 128, 160, 320, 3, 2, 1),
    "layer2": (128, 128, 80, 160, 3, 1, 1),
    "layer3-d2": (256, 256, 80, 160, 3, 1, 2),
    "layer4-d4": (512, 512, 80, 160, 3, 1, 4),
    "aspp-bottleneck": (2560, 512, 80, 160, 3, 1, 1),
    "mit-pe3-s2": (128, 320, 80, 160, 3, 2, 1),
}
PATH_GEMMS = {
    "layer3-conv1": (2 * 80 * 160, 1024, 256),
    "layer3-conv3": (2 * 80 * 160, 256, 1024),
    "aspp-global": (2, 2048, 512),
    "decoder-pointwise": (2 * 160 * 320, 560, 512),
    "mit-stage1-fc2": (2 * 160 * 320, 256, 64),
    "mit-stage3-fc1": (2 * 40 * 80, 320, 1280),
}


def _float_input(gen, shape, dtype):
    """Channels-last float activations with a tail past the absmax."""
    x = torch.randn(shape, generator=gen, device="cuda") * 2
    return x.to(dtype).contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("label", list(PATH_CONVS))
@pytest.mark.parametrize("b", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_path_convs_bit_exact(gen, label, b, dtype):
    """Kernels Q and I at the path's k x k shapes, each bit for bit
    against its plain version, float32 and bfloat16 in and out."""
    from halo_tpu_torch.ops import quant
    c, co, h, w, k, s, d = PATH_CONVS[label]
    x = _float_input(gen, (b, c, h, w), dtype)
    amax = torch.tensor(3.0, device="cuda")
    _, wq, packed, w_scale, _ = _int8_case(gen, 1, c, co, 1, 1, k)
    n, nq = quant.launches, quant.quant_launches
    xq = quant.quantize_nhwc(x, amax)
    got = quant.int8_conv_kernel(xq, packed, w_scale, amax, k, s, d, d,
                                 dtype)
    want_q = quant.quantize_nhwc_plain(x, amax)
    want = quant.int8_conv_plain(want_q[..., :c].permute(0, 3, 1, 2), wq,
                                 _scale(amax, w_scale), s, d, d, dtype)
    torch.cuda.synchronize()
    assert (quant.launches, quant.quant_launches) == (n + 1, nq + 1)
    assert torch.equal(xq, want_q)
    assert torch.equal(got, want)


@pytest.mark.parametrize("label", list(PATH_GEMMS))
@pytest.mark.parametrize("b", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_path_gemms_bit_exact(gen, label, b, dtype):
    """The 1x1 convs and dense layers of the path (M = 2 included) as
    ``int8_dense`` runs them, kernels Q and I each bit for bit against
    its plain version."""
    from halo_tpu_torch.ops import quant
    m, k, n_out = PATH_GEMMS[label]
    m = m * b // 2
    x = torch.randn((m, k), generator=gen, device="cuda").to(dtype) * 2
    amax = torch.tensor(3.0, device="cuda")
    _, wq, packed, w_scale, _ = _int8_case(gen, 1, k, n_out, 1, 1)
    n, nq = quant.launches, quant.quant_launches
    xq = quant.quantize_nhwc(quant._channels_view(x), amax)
    got = quant.int8_conv_kernel(xq, packed, w_scale, amax, 1, 1, 0, 1,
                                 dtype)
    want_q = quant.quantize_nhwc_plain(quant._channels_view(x), amax)
    want = quant.int8_gemm_plain(want_q.reshape(m, -1)[:, :k],
                                 wq[:, :, 0, 0], _scale(amax, w_scale), dtype)
    torch.cuda.synchronize()
    assert (quant.launches, quant.quant_launches) == (n + 1, nq + 1)
    assert torch.equal(xq, want_q)
    assert torch.equal(got.permute(0, 2, 3, 1).reshape(m, n_out), want)


@pytest.mark.parametrize("layout", ["aspp-concat", "nchw", "tokens-3d",
                                    "expanded"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_quantize_reads_any_layout(gen, layout, dtype):
    """Kernel Q on the layouts the path hands it, bit for bit against its
    plain version: the ASPP bottleneck's concatenation (channels-last
    branches and the broadcast global branch: not channels-last), NCHW,
    a strided (B, N, C) token view, a broadcast map; C = 2560, 1000 and
    300 (no multiple of 16: the padding is zero)."""
    from halo_tpu_torch.ops import quant
    amax = torch.tensor(2.5, device="cuda")
    if layout == "aspp-concat":
        parts = [_float_input(gen, (2, 512, 40, 80), dtype)
                 for _ in range(4)]
        pooled = torch.randn((2, 512, 1, 1), generator=gen, device="cuda")
        x = torch.cat([pooled.to(dtype).expand(-1, -1, 40, 80)] + parts,
                      dim=1)
    elif layout == "nchw":
        x = torch.randn((2, 1000, 33, 47), generator=gen,
                        device="cuda").to(dtype)
    elif layout == "tokens-3d":
        t = torch.randn((700, 2, 300), generator=gen,
                        device="cuda").to(dtype).transpose(0, 1)
        x = quant._channels_view(t)
    else:
        x = torch.randn((2, 300, 1, 1), generator=gen,
                        device="cuda").to(dtype).expand(-1, -1, 45, 61)
    n = quant.quant_launches
    got = quant.quantize_nhwc(x, amax)
    want = quant.quantize_nhwc_plain(x, amax)
    torch.cuda.synchronize()
    assert quant.quant_launches == n + 1
    assert got.shape == want.shape and torch.equal(got, want)
    c = x.shape[1]
    assert not got[..., c:].any()


@pytest.mark.parametrize("amax", [15.875, 3.0, 1e-3, 0.0, 2.5e4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_quantize_ties_bit_exact(gen, amax, dtype):
    """Kernel Q at and around the rounding boundaries, bit for bit
    against its plain version (an IEEE division on the card): values
    (k + 0.5) * sx and the floats next to them (where the kernel's
    reciprocal rule takes its exact fix-up), random values, values past
    +-amax, zeros and infinities."""
    from halo_tpu_torch.ops import quant
    a = torch.tensor(amax, device="cuda")
    sx = quant.quantize_act(torch.zeros(1, device="cuda"), a)[1]
    k = torch.randint(-130, 130, (1 << 14,), generator=gen, device="cuda")
    vals = [(k.float() + 0.5) * sx]
    for direction in (float("inf"), float("-inf")):
        v = vals[0]
        for _ in range(3):
            v = torch.nextafter(v, torch.full_like(v, direction))
            vals.append(v)
    vals.append((torch.rand((1 << 14,), generator=gen, device="cuda") * 260
                 - 130) * sx)
    vals.append(torch.tensor([0.0, -0.0, float("inf"), float("-inf"),
                              3e38, -3e38, 1e-45, -1e-45] * 8,
                             device="cuda"))
    x = torch.cat(vals).to(dtype).reshape(-1, 64)
    xv = quant._channels_view(x)
    got = quant.quantize_nhwc(xv, a)
    want = quant.quantize_nhwc_plain(xv, a)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# The sites where kernel Q applies its producer's frozen norm and ReLU, at
# R101's shapes for a 640x1280 input (B = 2 and 4): (C, H, W) of the map
# the norm reads. Each bottleneck's conv2 and conv3 inputs (layer2.0's
# strided conv2 reads 160x320), the ASPP branches' and the decoder's
# pointwise convs.
FUSED_SITES = {
    "layer1": (64, 160, 320),
    "layer2.0-conv2": (128, 160, 320),
    "layer2": (128, 80, 160),
    "layer3": (256, 80, 160),
    "layer4": (512, 80, 160),
    "aspp-pointwise": (2048, 80, 160),
    "decoder.0-pointwise": (560, 160, 320),
    "decoder.1-pointwise": (512, 160, 320),
}


def _frozen_bn(gen, c):
    """A FrozenBatchNorm2d on the card with random statistics."""
    from halo_tpu_torch.models.layers import FrozenBatchNorm2d
    bn = FrozenBatchNorm2d(c).cuda()
    with torch.no_grad():
        bn.weight.copy_(torch.rand((c,), generator=gen, device="cuda") + 0.5)
        bn.bias.copy_(torch.randn((c,), generator=gen, device="cuda") * 0.3)
        bn.running_mean.copy_(torch.randn((c,), generator=gen,
                                          device="cuda") * 0.3)
        bn.running_var.copy_(torch.rand((c,), generator=gen,
                                        device="cuda") * 1.5 + 0.5)
    return bn


def _fused_against_plain(sources, amax, bn=None, relu=True):
    """Kernel Q with the prologue against its plain version on the card and
    against the unfused ops (the norm module, torch.relu, kernel Q alone),
    all bit for bit; one launch of Q, counted as fused."""
    from halo_tpu_torch.ops import quant
    dtype = sources[0].dtype
    scale, shift = bn.affine(dtype) if bn is not None else (None, None)
    n, nf = quant.quant_launches, quant.fused_launches
    got = quant.quantize_fused(sources, amax, scale, shift, relu)
    torch.cuda.synchronize()
    assert quant.quant_launches == n + 1
    assert quant.fused_launches == nf + int(bn is not None or relu)
    want = quant.quantize_fused_plain(sources, amax, scale, shift, relu)
    assert got.shape == want.shape and torch.equal(got, want)
    x = torch.cat(sources, dim=1) if len(sources) > 1 else sources[0]
    if bn is not None:
        x = bn(x)
    unfused = quant.quantize_nhwc(torch.relu(x) if relu else x, amax)
    torch.cuda.synchronize()
    assert torch.equal(got, unfused)
    return got


@pytest.mark.parametrize("label", list(FUSED_SITES))
@pytest.mark.parametrize("b", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_quantize_fused_sites_bit_exact(gen, label, b, dtype):
    """Kernel Q with a frozen norm's affine and the ReLU at every fused
    site's shape, channels-last as the model makes it."""
    c, h, w = FUSED_SITES[label]
    x = _float_input(gen, (b, c, h, w), dtype)
    _fused_against_plain([x], torch.tensor(3.0, device="cuda"),
                         _frozen_bn(gen, c))


@pytest.mark.parametrize("b", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_quantize_reads_the_aspp_branches_in_place(gen, b, dtype):
    """The ASPP bottleneck's five sources, as the model hands them over:
    the global branch's (B, 512, 1, 1) map expanded over the pixels
    (strides 0) and four channels-last (B, 512, 80, 160) branches, against
    kernel Q's plain version of their torch.cat; not counted as fused."""
    from halo_tpu_torch.ops import quant
    pooled = torch.randn((b, 512, 1, 1), generator=gen,
                         device="cuda").to(dtype)
    sources = [pooled.expand(-1, -1, 80, 160)] + [
        _float_input(gen, (b, 512, 80, 160), dtype) for _ in range(4)]
    amax = torch.tensor(2.5, device="cuda")
    n, nf = quant.quant_launches, quant.fused_launches
    got = quant.quantize_fused(sources, amax)
    want = quant.quantize_nhwc_plain(torch.cat(sources, dim=1), amax)
    torch.cuda.synchronize()
    assert (quant.quant_launches, quant.fused_launches) == (n + 1, nf)
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["specials", "c40", "nchw", "amax0",
                                  "mixed-sources", "relu-only"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_quantize_fused_edges(gen, case, dtype):
    """The prologue at the edges: NaN, +-inf and -0 in the input (torch's
    ReLU keeps a NaN, which converts to 0); C = 40 (no multiple of 16:
    the tile path); an NCHW input (the tile path); amax = 0 (every nonzero
    value clips); sources in several layouts, one of 24 channels and one
    broadcast; the ReLU alone."""
    amax = torch.tensor(0.0 if case == "amax0" else 2.0, device="cuda")
    c = 40 if case == "c40" else 96
    if case == "mixed-sources":
        sources = [
            torch.randn((2, 16, 1, 1), generator=gen,
                        device="cuda").to(dtype).expand(-1, -1, 13, 17),
            _float_input(gen, (2, 32, 13, 17), dtype),
            torch.randn((2, 24, 13, 17), generator=gen,
                        device="cuda").to(dtype),
            _float_input(gen, (2, 48, 13, 17), dtype)]
        _fused_against_plain(sources, amax, _frozen_bn(gen, 120))
        return
    x = torch.randn((2, c, 13, 17), generator=gen, device="cuda") * 2
    if case == "specials":
        flat = x.view(-1)
        idx = torch.randperm(flat.numel(), generator=gen,
                             device="cuda")[:64]
        flat[idx] = torch.tensor([float("nan"), float("inf"),
                                  float("-inf"), -0.0] * 16, device="cuda")
    x = x.to(dtype)
    if case != "nchw":
        x = x.contiguous(memory_format=torch.channels_last)
    bn = None if case == "relu-only" else _frozen_bn(gen, c)
    got = _fused_against_plain([x], amax, bn)
    if case == "amax0":
        assert int((got[..., :c].abs() == 127).sum()) > x.numel() // 3


def test_int8_conv_layer_matches_plain_with_clipping(gen):
    """``int8_conv`` end to end on float input: amax below max|x| clips;
    amax = 0 gives the smallest scale (1e-12 / 127), so every activation
    clips to +-127 and the outputs are finite and tiny; the kernel and the
    plain version on the same quantised input give the same bits."""
    from halo_tpu_torch.ops import quant
    x = torch.randn((2, 64, 17, 23), generator=gen, device="cuda")
    x = x.contiguous(memory_format=torch.channels_last)
    wt = torch.randn((96, 64, 3, 3), generator=gen, device="cuda")
    w_int8, w_scale = quant.quantize_weight(wt)
    for amax in (float(x.abs().max()), 1.0, 0.0):
        amax = torch.tensor(amax, device="cuda")
        got = quant.int8_conv(x, w_int8, w_scale, amax, 1, 2, 2)
        xq, sx = quant.quantize_act(x, amax)
        want = quant.int8_conv_plain(xq, w_int8, sx * w_scale, 1, 2, 2)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        if float(amax) == 0.0:
            assert bool(torch.isfinite(got).all())
            assert float(got.abs().max()) < 1e-6


def test_int8_layers_launch_two_kernels(gen, monkeypatch):
    """Every quantised layer, calibrated on the card, runs kernel Q then
    kernel I (one launch each) and nothing else of ours; ``torch._int_mm``
    never."""
    from halo_tpu_torch.models.layers import QuantConv, QuantDense
    from halo_tpu_torch.ops import quant

    def refuse(*args, **kwargs):
        raise AssertionError("torch._int_mm ran on the int8 path")

    monkeypatch.setattr(torch, "_int_mm", refuse)
    x = torch.randn((2, 256, 96, 128), generator=gen, device="cuda")
    layers = [QuantConv(256, 64, 3, padding=2, dilation=2),
              QuantConv(256, 128, 1), QuantConv(256, 96, 1, stride=2),
              QuantDense(256, 40)]
    for layer in layers:
        layer = layer.cuda().eval()
        inp = x.permute(0, 2, 3, 1) if isinstance(layer, QuantDense) else x
        quant.calibrate(layer, [inp])
        assert torch.equal(layer.w_packed, quant.pack_weight(
            layer.w_int8.reshape(layer.w_int8.shape[:2] + (
                layer.w_int8.shape[2:] or (1, 1)))))
        n, nq = quant.launches, quant.quant_launches
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            y = layer(inp)
        torch.cuda.synchronize()
        assert (quant.launches, quant.quant_launches) == (n + 1, nq + 1)
        assert y.dtype == torch.bfloat16 and bool(torch.isfinite(y).all())


@pytest.mark.parametrize("m,k,n", [(25600, 256, 1024), (2, 2048, 512),
                                   (100, 20, 36), (4096, 320, 1280)])
def test_int8_gemm_matches_plain(gen, m, k, n):
    """Kernel I as a one-tap GEMM (the dense route: rows of int8 ``a``
    against ``w``) against the plain product, exact, float32 and
    bfloat16 out."""
    from halo_tpu_torch.ops import quant
    a, wq, packed, w_scale, amax = _int8_case(gen, 1, k, n, m, 1)
    before = quant.launches
    for dtype in (torch.float32, torch.bfloat16):
        got = quant.int8_conv_kernel(a, packed, w_scale, amax, 1, 1, 0, 1,
                                     dtype)
        want = quant.int8_gemm_plain(a.reshape(m, -1)[:, :k], wq[:, :, 0, 0],
                                     _scale(amax, w_scale), dtype)
        torch.cuda.synchronize()
        assert torch.equal(got.reshape(n, m).t(), want)
    assert quant.launches == before + 2


def test_int8_conv_refuses(gen):
    from halo_tpu_torch import kernels
    from halo_tpu_torch.ops import quant
    xq, wq, packed, w_scale, amax = _int8_case(gen, 1, 32, 16, 8, 8, 3)
    n, nq = quant.launches, quant.quant_launches
    with pytest.raises(TypeError):        # no float activations
        quant.int8_conv_kernel(xq.float(), packed, w_scale, amax, 3)
    with pytest.raises(TypeError):        # no float16 output
        quant.int8_conv_kernel(xq, packed, w_scale, amax, 3,
                               out_dtype=torch.float16)
    with pytest.raises(ValueError):       # Cin mismatch
        quant.int8_conv_kernel(xq[..., :16].contiguous(), packed, w_scale,
                               amax, 3)
    with pytest.raises(ValueError):       # amax on the host
        quant.int8_conv_kernel(xq, packed, w_scale, amax.cpu(), 3)
    with pytest.raises(ValueError):       # stride beyond TMA's 8
        quant.int8_conv_kernel(xq, packed, w_scale, amax, 3, 9)
    with pytest.raises(TypeError):        # no float16 input to Q
        quant.quantize_nhwc(torch.zeros((1, 8, 4, 4), device="cuda",
                                        dtype=torch.float16), amax)
    assert (quant.launches, quant.quant_launches) == (n, nq)
    y = torch.empty((1, 6, 6, 16), device="cuda")
    lib = kernels.load()
    err = lib.halo_int8_conv(    # C % 16 != 0 at the C entry
        xq.data_ptr(), packed.data_ptr(), amax.data_ptr(),
        w_scale.data_ptr(), y.data_ptr(), 0, 1, 8, 8, 24, 6, 6, 16, 16, 3, 3,
        1, 1, 0, 0, 1, 1, 1e-12, 1 / 127, kernels.current_stream(xq.device))
    with pytest.raises(RuntimeError, match="CUDA error"):
        kernels.check(err, "halo_int8_conv")
    import ctypes
    desc = (ctypes.c_longlong * 7)(y.data_ptr(), 0, 40, 2560, 64, 320, 8)
    err = lib.halo_int8_quantize(    # Cp below C at the C entry
        1, desc, 0, amax.data_ptr(), None, None, 0, xq.data_ptr(), 1, 8, 8,
        32, 1e-12, 1 / 127, kernels.current_stream(xq.device))
    with pytest.raises(RuntimeError, match="CUDA error"):
        kernels.check(err, "halo_int8_quantize")
    desc = (ctypes.c_longlong * 7)(y.data_ptr(), 16, 16, 2560, 64, 320, 8)
    err = lib.halo_int8_quantize(    # a first source not at channel 0
        1, desc, 0, amax.data_ptr(), None, None, 0, xq.data_ptr(), 1, 8, 8,
        32, 1e-12, 1 / 127, kernels.current_stream(xq.device))
    with pytest.raises(RuntimeError, match="CUDA error"):
        kernels.check(err, "halo_int8_quantize")
