"""Greedy region selection and mask replay on torch tensors.

Port of ``halo_tpu/active/selection.py``: repeatedly take the score argmax
(torch first-occurrence tie-break), label the (2r+1)^2 region from ground
truth and suppress the (2m+1)^2 neighbourhood, for ``num_picks`` picks.

``select_pixels_to_label`` is the plain column-cache loop;
``cuda_select_pixels_to_label`` runs the picks through kernel A
(``cuda_select.greedy_picks``, its plain version on a CPU tensor), and
``cuda_select_pixels_to_label_batch`` does so for a stack of images of one
size in one launch. All replay the picks onto the masks with
``apply_picks``, image by image.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .cuda_select import NEG_INF, greedy_picks, greedy_picks_reference


class SelectionResult(NamedTuple):
    score: torch.Tensor        # (H, W) suppressed score map
    active: torch.Tensor       # (H, W) bool: suppression/active indicator
    selected: torch.Tensor     # (H, W) bool: labeled-region indicator
    active_mask: torch.Tensor  # (H, W) labels: GT in selected regions
    picks: torch.Tensor        # (N, 2) int32 (h, w); -1 rows = unused budget
    num_picked: torch.Tensor   # () int32


def _windows(picks, radius: int, h_dim: int, w_dim: int):
    """(rows, cols) of every in-map pixel of the (2*radius+1)^2 windows
    around the valid picks."""
    hw = picks[picks[:, 0] >= 0].long()
    d = torch.arange(-radius, radius + 1, device=picks.device)
    rows = (hw[:, 0, None, None] + d[None, :, None]).expand(-1, d.numel(),
                                                              d.numel())
    cols = (hw[:, 1, None, None] + d[None, None, :]).expand(-1, d.numel(),
                                                              d.numel())
    keep = (rows >= 0) & (rows < h_dim) & (cols >= 0) & (cols < w_dim)
    return rows[keep], cols[keep]


def apply_picks(picks, active_mask, ground_truth, active, selected, *,
                active_radius: int, mask_radius: int):
    """Replay pick coordinates onto the mask canvases: active_mask takes
    the GT over each (2r+1)^2 region, selected |= region, active |= the
    (2m+1)^2 window. Every overlapping pick writes the same GT values and
    the rest is |=, so one vectorised scatter per canvas gives the JAX
    package's sequential replay bit for bit.

    Returns (active_mask, selected, active), each (H, W).
    """
    h_dim, w_dim = active_mask.shape
    am, sel, act = active_mask.clone(), selected.clone(), active.clone()
    rows, cols = _windows(picks, active_radius, h_dim, w_dim)
    am[rows, cols] = ground_truth[rows, cols].to(am.dtype)
    sel[rows, cols] = True
    rows, cols = _windows(picks, mask_radius, h_dim, w_dim)
    act[rows, cols] = True
    return am, sel, act


def _replay(score, picks, num_picked, active_mask, ground_truth, active,
            selected, active_radius, mask_radius):
    """One image's result from its picks; ``score`` is already -inf on
    ``active``."""
    am, sel, act = apply_picks(picks, active_mask, ground_truth, active,
                               selected, active_radius=active_radius,
                               mask_radius=mask_radius)
    # the suppressed score is -inf exactly on the updated active set
    score_out = torch.where(act, NEG_INF, score)
    return SelectionResult(score_out, act, sel, am, picks, num_picked)


def _select(picks_fn, score, active_mask, ground_truth, active, selected,
            num_picks, active_radius, mask_radius):
    score = torch.where(active, NEG_INF, score.float())
    picks, num_picked = picks_fn(score, num_picks=num_picks,
                                 mask_radius=mask_radius)
    return _replay(score, picks, num_picked, active_mask, ground_truth,
                   active, selected, active_radius, mask_radius)


def select_pixels_to_label(score, active_mask, ground_truth, active,
                           selected, *, num_picks: int, active_radius: int,
                           mask_radius: int) -> SelectionResult:
    """Greedy budget selection on one (H, W) score map with the plain
    column-cache loop (any device).

    score: (H, W) float map; active: (H, W) bool pixels already taken
    (scored -inf here); active_mask / ground_truth: (H, W) int labels;
    selected: (H, W) bool; num_picks: region budget; active_radius /
    mask_radius: r and m.
    """
    return _select(greedy_picks_reference, score, active_mask, ground_truth,
                   active, selected, num_picks, active_radius, mask_radius)


def cuda_select_pixels_to_label(score, active_mask, ground_truth, active,
                                selected, *, num_picks: int,
                                active_radius: int,
                                mask_radius: int) -> SelectionResult:
    """Same contract as select_pixels_to_label, with the pick loop in
    kernel A on a CUDA tensor (its plain version on a CPU tensor)."""
    return _select(greedy_picks, score, active_mask, ground_truth, active,
                   selected, num_picks, active_radius, mask_radius)


def cuda_select_pixels_to_label_batch(scores, active_masks, ground_truths,
                                      actives, selecteds, *, num_picks: int,
                                      active_radius: int, mask_radius: int):
    """cuda_select_pixels_to_label for n images of one size that share a
    budget: each argument is an (n, H, W) stack of the per-image argument.
    Masks every image's taken pixels with -inf, runs all picks in one
    kernel-A launch (map by map on the CPU), then replays each image's
    picks. Returns a list of n SelectionResult, each equal to what
    cuda_select_pixels_to_label gives for that image."""
    scores = torch.where(actives, NEG_INF, scores.float())
    picks, num_picked = greedy_picks(scores, num_picks=num_picks,
                                     mask_radius=mask_radius)
    return [_replay(scores[i], picks[i], num_picked[i], active_masks[i],
                    ground_truths[i], actives[i], selecteds[i],
                    active_radius, mask_radius)
            for i in range(scores.shape[0])]
