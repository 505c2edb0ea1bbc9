"""Port parity, selection: the plain column-cache twin
(select_pixels_to_label) and the kernel path's CPU route
(cuda_select_pixels_to_label) against both the JAX XLA loop and the
Pallas kernel in interpret mode. Selection only compares values, so
everything must be bit-exact: picks, num_picked, active_mask, active,
selected and the suppressed score."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo_tpu.active import selection as jsel
from halo_tpu_torch.active import cuda_select
from halo_tpu_torch.active import selection as tsel


# One shape and budget for every case, so each JAX program compiles once.
H, W, N, R, M = 32, 48, 15, 1, 3


def _compare(score, active, seed=0, n=N, r=R, m=M):
    h, w = score.shape
    rng = np.random.default_rng(seed)
    gt = rng.integers(0, 19, (h, w)).astype(np.int32)
    gt[::7, ::5] = 255
    am = np.full((h, w), 255, np.int32)
    selected = np.zeros((h, w), bool)
    kw = dict(num_picks=n, active_radius=r, mask_radius=m)
    j_args = [jnp.asarray(a) for a in (score, am, gt, active, selected)]
    t_args = [torch.from_numpy(a.copy()) for a in
              (score, am, gt, active, selected)]
    refs = [jsel.select_pixels_to_label(*j_args, **kw),
            jsel.pallas_select_pixels_to_label(*j_args, interpret=True, **kw)]
    gots = [tsel.select_pixels_to_label(*t_args, **kw),
            tsel.cuda_select_pixels_to_label(*t_args, **kw)]
    for ref in refs:
        for got in gots:
            for field in ("picks", "active_mask", "active", "selected",
                          "score"):
                np.testing.assert_array_equal(
                    getattr(got, field).numpy(),
                    np.asarray(getattr(ref, field)), err_msg=field)
            assert int(got.num_picked) == int(ref.num_picked)
    return gots[0]


@pytest.mark.parametrize("seed", [0, 3])
def test_matches_xla_loop_and_pallas_kernel(seed):
    rng = np.random.default_rng(seed)
    score = rng.normal(size=(H, W)).astype(np.float32)
    active = np.zeros((H, W), bool)
    active[:6, :6] = True
    got = _compare(score, active, seed=seed)
    assert int(got.num_picked) == N


def test_early_stop():
    score = np.full((H, W), -np.inf, np.float32)
    score[4, 7] = 2.0
    score[12, 2] = 1.0
    got = _compare(score, np.zeros((H, W), bool))
    assert int(got.num_picked) == 2
    np.testing.assert_array_equal(got.picks[:2].numpy(), [[4, 7], [12, 2]])
    assert (got.picks[2:] == -1).all()


def test_tie_plateau_and_borders():
    """Exact ties decide by smallest column, then smallest row; plateaus
    on the map's corners and edges clip the windows."""
    rng = np.random.default_rng(7)
    score = rng.normal(size=(H, W)).astype(np.float32)
    score[0:4, 44:48] = 5.0      # top-right corner plateau
    score[29:32, 0:3] = 5.0      # bottom-left corner plateau
    score[8:11, 20] = 5.0        # a column of ties mid-map
    score[31, 25:28] = 4.0       # bottom edge
    active = np.zeros((H, W), bool)
    active[0, :] = True          # the top row is taken already
    got = _compare(score, active)
    assert got.picks[0].tolist() == [29, 0]


def test_plain_picks_are_the_wrapper_cpu_route():
    score = torch.from_numpy(
        np.random.default_rng(9).normal(size=(24, 40)).astype(np.float32))
    a = cuda_select.greedy_picks(score, num_picks=9, mask_radius=2)
    b = cuda_select.greedy_picks_reference(score, num_picks=9, mask_radius=2)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert cuda_select.launches == 0


def _stack_of_maps():
    """Four (H, W) maps and their pre-active masks: a pre-active block, a
    tie plateau, one that runs out of finite scores after 3 picks, and a
    smooth (5x5 box-filtered) map."""
    rng = np.random.default_rng(11)
    scores = rng.normal(size=(4, H, W)).astype(np.float32)
    active = np.zeros((4, H, W), bool)
    active[0, 3:12, 10:30] = True
    scores[1, 10:16, 20:28] = 4.0
    scores[2] = -np.inf
    scores[2, 5, 5], scores[2, 20, 40], scores[2, 30, 2] = 1.0, 3.0, 2.0
    pad = np.pad(rng.normal(size=(H, W)), 2, mode="edge")
    scores[3] = sum(pad[i:i + H, j:j + W] for i in range(5)
                    for j in range(5)).astype(np.float32) / 25
    return scores, active


def test_batched_picks_match_jax_per_image():
    scores, active = _stack_of_maps()
    masked = np.where(active, -np.inf, scores).astype(np.float32)
    picks, counts = cuda_select.greedy_picks(torch.from_numpy(masked),
                                             num_picks=N, mask_radius=M)
    assert picks.shape == (4, N, 2) and counts.shape == (4,)
    for i in range(4):
        ref = jsel.select_pixels_to_label(
            jnp.asarray(scores[i]), jnp.full((H, W), 255, jnp.int32),
            jnp.zeros((H, W), jnp.int32), jnp.asarray(active[i]),
            jnp.zeros((H, W), bool), num_picks=N, active_radius=R,
            mask_radius=M)
        np.testing.assert_array_equal(picks[i].numpy(),
                                      np.asarray(ref.picks), err_msg=str(i))
        assert int(counts[i]) == int(ref.num_picked)
    assert int(counts[2]) == 3 and (picks[2, 3:] == -1).all()


def test_batched_selection_matches_jax_per_image():
    scores, active = _stack_of_maps()
    rng = np.random.default_rng(12)
    gt = rng.integers(0, 19, (4, H, W)).astype(np.int32)
    am = np.full((4, H, W), 255, np.int32)
    selected = active.copy()
    kw = dict(num_picks=N, active_radius=R, mask_radius=M)
    got = tsel.cuda_select_pixels_to_label_batch(
        *[torch.from_numpy(a.copy())
          for a in (scores, am, gt, active, selected)], **kw)
    assert len(got) == 4
    for i in range(4):
        ref = jsel.select_pixels_to_label(
            *[jnp.asarray(a[i]) for a in (scores, am, gt, active, selected)],
            **kw)
        for field in ("picks", "active_mask", "active", "selected",
                      "score"):
            np.testing.assert_array_equal(
                getattr(got[i], field).numpy(),
                np.asarray(getattr(ref, field)), err_msg=f"{i} {field}")
        assert int(got[i].num_picked) == int(ref.num_picked)
