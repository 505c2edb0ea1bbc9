"""The split of kernel C's weight-gradient kernel, on the CPU.

``ops/dilated_conv.wgrad_plan`` chooses how ``csrc/dilated_conv_wgrad.cu``
cuts a call: each tile's pixel steps dealt into ``period`` residues, the
(tile, residue) units cut into ``grid`` contiguous ranges, one a block;
``wgrad_step`` gives the pixel step's shape at a dilation. The kernel
derives the same split from (period, grid) by the formulas of
``WgradPlan``, so these tests hold the plan to what the kernel needs: at
the recipe's five dk shapes (R101 layer3 and layer4 at the source's
2x90x160 and the target's 2x80x160) on an H100's 132 SMs, and at the card
tests' edge shapes, every (tile, pixel step) unit is covered exactly once,
the grid is at most the SM count, and each tile's partials are summed in
one fixed order.
"""

import math
from collections import Counter

import pytest

from halo_tpu_torch.ops import dilated_conv as dc

SMS = 132

# (B, C, Co, H, W, d): d does not change the split
RECIPE = [
    (2, 256, 256, 90, 160, 2),    # layer3, source
    (2, 512, 512, 90, 160, 2),    # layer4, source
    (2, 512, 512, 90, 160, 4),
    (2, 256, 256, 80, 160, 2),    # layer3, target
    (2, 512, 512, 80, 160, 4),    # layer4, target
]
EDGES = [
    (1, 64, 96, 7, 13, 3),
    (1, 32, 64, 9, 37, 1),
    (2, 96, 160, 13, 45, 4),
    (1, 160, 96, 6, 70, 2),
    (2, 160, 96, 40, 96, 2),      # C = 160, Co = 96: ragged tiles both ways
    (2, 128, 512, 16, 40, 2),
    (1, 32, 32, 3, 5, 1),
    (1, 32, 64, 4, 40, 1),        # 5 pixel steps: fewer than the SMs
    (1, 64, 96, 12, 50, 9),       # d = 9: three x boxes a step
    (1, 32, 64, 20, 70, 16),      # d = 16: one wide box of 1 x 96 pixels
    (1, 64, 64, 1, 1, 1),
    (1, 64, 32, 5, 9, 8),
    (1, 1024, 1024, 8, 64, 1),    # 288 tiles: more than the SMs
]


def plan_of(shape, sms=SMS):
    b, c, co, h, w, d = shape
    return dc.wgrad_plan(b, h, w, c, co, d, sms)


def kernel_steps(plan, r0, r1):
    """The pixel steps of a segment as the kernel's producer walks them:
    the next residue, or the first residue of the next period."""
    out, kt, r = [], r0, r0
    while kt < plan.steps:
        out.append(kt)
        adv = 1
        r += 1
        if r == r1:
            r, adv = r0, plan.period - (r1 - r0) + 1
        kt += adv
    return out


@pytest.mark.parametrize("shape", RECIPE + EDGES)
def test_plan_covers_every_unit_once(shape):
    plan = plan_of(shape)
    assert 1 <= plan.grid <= SMS and plan.grid <= plan.units
    assert 1 <= plan.period <= plan.steps
    seen = Counter()
    for blk in range(plan.grid):
        for tile, r0, r1 in plan.segments(blk):
            assert 0 <= tile < plan.tiles and 0 <= r0 < r1 <= plan.period
            kts = plan.pixel_steps(r0, r1)
            assert kts == kernel_steps(plan, r0, r1)
            assert kts == sorted(kts)  # the block sweeps the image in order
            assert len(kts) == plan.segment_steps(r0, r1) >= 1
            seen.update((tile, kt) for kt in kts)
    assert set(seen) == {(t, k) for t in range(plan.tiles)
                         for k in range(plan.steps)}
    assert set(seen.values()) == {1}


@pytest.mark.parametrize("shape", RECIPE + EDGES)
def test_each_tile_sums_in_one_fixed_order(shape):
    plan = plan_of(shape)
    assert plan_of(shape) == plan  # the same plan every call
    finisher_of = Counter()
    for tile in range(plan.tiles):
        holders = [blk for blk in range(plan.grid)
                   if any(s[0] == tile for s in plan.segments(blk))]
        blocks = plan.contributors(tile)
        assert list(blocks) == holders  # summed in block order
        finishers = plan.finishers(tile)
        assert len(finishers) >= 1
        assert list(finishers) == holders[:len(finishers)]
        if len(holders) == 1:  # held whole: written from the registers
            assert plan.segments(holders[0]).count((tile, 0, plan.period))
            continue
        for blk in holders:
            # a block finishes the shared tile its range ends in, only that
            last = plan.segments(blk)[-1][0] == tile
            assert (blk in finishers) == last
            finisher_of[blk] += blk in finishers
    assert set(finisher_of.values()) <= {1}
    slots = [blk + tile for blk in range(plan.grid)
             for tile, r0, r1 in plan.segments(blk)
             if r1 - r0 < plan.period]
    assert len(slots) == len(set(slots))  # no two partials share a slot


@pytest.mark.parametrize("shape", RECIPE)
def test_recipe_plans_fill_the_card_in_one_wave(shape):
    plan = plan_of(shape)
    assert plan.grid == SMS
    ideal = plan.tiles * plan.steps / SMS
    worst = max(sum(plan.segment_steps(r0, r1) for _, r0, r1
                    in plan.segments(blk)) for blk in range(plan.grid))
    assert worst <= 1.06 * ideal
    assert max(len(plan.segments(blk)) for blk in range(plan.grid)) <= 2


@pytest.mark.parametrize("d", [*range(1, 18), 24, 40, 56, 64, 65, 72, 96,
                               100])
def test_pixel_step_shapes(d):
    """One x box serves a row's three taps when a tap's shift, d columns,
    moves the box's 128-byte rows by whole 1024-byte swizzle atoms (hs * d
    rows, a multiple of 8) and the box fits TMA (256 columns at most);
    else three 2 x 32 boxes. A stage (the 16 KB of g and x) leaves at
    least 5 in the kernel's 208 KB ring."""
    hs, wsz, x_bytes = dc.wgrad_step(d)
    assert hs * wsz == 64
    if d * 8 // math.gcd(d, 8) > 64:
        assert (hs, wsz, x_bytes) == (2, 32, 3 * 8192)
    else:
        assert (hs * d) % 8 == 0 and wsz + 2 * d <= 256
        assert x_bytes == 64 * 2 * hs * (wsz + 2 * d) <= 3 * 8192
    assert (208 * 1024) // (16384 + x_bytes) >= 5


def test_plan_reckons_the_l2_bytes():
    plan = plan_of(RECIPE[0])
    # d = 2: steps of 4 x 16 pixels, 23 x 10 of them an image; 24 tiles
    # (3 tap rows x 4 x 2); a step 16 KB of g and a 4 x 20 x 64 x box
    assert (plan.steps, plan.tiles) == (2 * 23 * 10, 24)
    assert plan.operand_bytes() == 24 * 460 * (16384 + 10240)
    shared = sum(r1 - r0 < plan.period for blk in range(plan.grid)
                 for _, r0, r1 in plan.segments(blk))
    assert plan.partial_bytes() == 2 * shared * 3 * 64 * 128 * 4
    whole = plan_of((1, 64, 64, 1, 1, 1))
    assert whole.period == 1 and whole.partial_bytes() == 0


@pytest.mark.parametrize("name", ["base", "noload", "nomma", "divide"])
def test_probe_variants_apply_to_the_kernel_source(name):
    """tools/wgrad_probe.py edits the kernel's source by text: every
    anchor it needs is there, and each variant takes out what it says."""
    from halo_tpu_torch.tools import wgrad_probe
    src = wgrad_probe.variant_source(name)
    assert src.count("g_probe[blockIdx.x") == wgrad_probe.STAMPS
    assert ("tma_load_4d(dst" in src) == (name != "noload")
    assert ("wgmma_m64n128k16<1, 1>(acc" in src) == (name != "nomma")
    assert (src.count("it_ % a.stages") == 2) == (name == "divide")



@pytest.mark.parametrize("steps", [1, 8, 32])
def test_probe_flush_variant_edits_the_run_length(steps):
    """The step-0 mode's copies of the kernel differ from it in the
    length of a tensor-core run alone."""
    from halo_tpu_torch.tools import wgrad_probe
    src = (wgrad_probe.kernels.CSRC / "dilated_conv_wgrad.cu").read_text()
    got = wgrad_probe.flush_source(steps)
    changed = [(a, b) for a, b in zip(src.splitlines(), got.splitlines())
               if a != b]
    assert len(got.splitlines()) == len(src.splitlines())
    assert len(changed) <= 1
    assert f"constexpr int kFlush = {steps};" in got
    if changed:
        assert changed[0][0].startswith(wgrad_probe.FLUSH)
