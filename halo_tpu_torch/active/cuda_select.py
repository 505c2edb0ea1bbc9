"""Kernel A: greedy region picks (CUDA).

Counterpart of ``halo_tpu/active/pallas_select.py``. ``greedy_picks`` is
the wrapper: on a CUDA tensor it launches ``csrc/select.cu`` once for one
map or a stack of maps (or raises); on a CPU tensor it takes the plain
version, ``greedy_picks_reference``, the column-cache loop of
``halo_tpu.active.selection.select_pixels_to_label``, map by map. Both only
compare values, so they agree bit for bit. Scores are expected free of NaN
(the score chain never makes one on finite inputs); NaN is not ordered
like ``jnp.argmax`` orders it.
"""

from __future__ import annotations

import torch

from .. import kernels

NEG_INF = float("-inf")

# Launches of the CUDA kernel, counted where it launches and nowhere else.
launches = 0


def greedy_picks_reference(score, *, num_picks: int, mask_radius: int):
    """Plain version: the greedy budget loop with a per-column
    (max, first-argmax-row) cache. Returns (picks (N, 2) int32 rows [h, w]
    with -1 padding, num_picked () int32), on ``score``'s device."""
    h_dim, w_dim = score.shape
    m = mask_radius
    score = score.float().clone()
    colmax = score.amax(dim=0)
    colrow = torch.argmax(score, dim=0)  # first occurrence
    picks = torch.full((num_picks, 2), -1, dtype=torch.int32)
    n = 0
    for i in range(num_picks):
        w = int(torch.argmax(colmax))
        if float(colmax[w]) == NEG_INF:
            break
        hh = int(colrow[w])
        picks[i, 0], picks[i, 1] = hh, w
        c0, c1 = max(w - m, 0), min(w + m + 1, w_dim)
        score[max(hh - m, 0):min(hh + m + 1, h_dim), c0:c1] = NEG_INF
        block = score[:, c0:c1]
        colmax[c0:c1] = block.amax(dim=0)
        colrow[c0:c1] = torch.argmax(block, dim=0)
        n += 1
    return (picks.to(score.device),
            torch.tensor(n, dtype=torch.int32, device=score.device))


def greedy_picks(score, *, num_picks: int, mask_radius: int):
    """Greedy picks on one (H, W) float32 score map, or on a stack (n, H, W)
    of maps that share the budget (-inf on pixels that may not be picked).
    Returns (picks (N, 2) int32, num_picked () int32) for one map, or
    (picks (n, N, 2), num_picked (n,)) for a stack, on ``score``'s device;
    ``score`` itself is not modified. A stack is one kernel launch."""
    if score.dim() not in (2, 3):
        raise TypeError("greedy_picks: needs an (H, W) map or an (n, H, W) "
                        f"stack, got {tuple(score.shape)}")
    if score.device.type == "cpu":
        if score.dim() == 2:
            return greedy_picks_reference(score, num_picks=num_picks,
                                          mask_radius=mask_radius)
        outs = [greedy_picks_reference(s, num_picks=num_picks,
                                       mask_radius=mask_radius)
                for s in score]
        return (torch.stack([p for p, _ in outs]),
                torch.stack([c for _, c in outs]))
    if score.device.type != "cuda":
        raise ValueError(f"greedy_picks: unsupported device {score.device}")
    if score.dtype != torch.float32:
        raise TypeError(f"greedy_picks: needs float32 maps, got {score.dtype}")
    if num_picks < 0 or mask_radius < 0:
        raise ValueError("greedy_picks: num_picks and mask_radius must be "
                         ">= 0")
    maps = score[None] if score.dim() == 2 else score
    n, h_dim, w_dim = maps.shape
    picks = torch.empty((n, num_picks, 2), dtype=torch.int32,
                        device=score.device)
    count = torch.zeros((n,), dtype=torch.int32, device=score.device)
    if num_picks > 0:
        # Scratch copy, transposed so each column is contiguous; the kernel
        # writes -inf into it. Beside it, room for the segment caches.
        score_t = maps.transpose(1, 2).contiguous()
        scratch = torch.empty(2 * n * w_dim * -(-h_dim // 32),
                              dtype=torch.int32, device=score.device)
        lib = kernels.load()
        err = lib.halo_greedy_picks(
            score_t.data_ptr(), n, h_dim, w_dim, num_picks, mask_radius,
            picks.data_ptr(), count.data_ptr(), scratch.data_ptr(),
            kernels.current_stream(score.device))
        kernels.check(err, "halo_greedy_picks")
        global launches
        launches += 1
    if score.dim() == 2:
        return picks[0], count[0]
    return picks, count
