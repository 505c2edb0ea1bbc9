"""Losses of the train step: masked CE, negative learning, local
consistency (port of ``halo_tpu/losses/losses.py``).

Logits are channel-last ``(N, H, W, C)``, labels ``(N, H, W)`` integers;
every loss is computed in float32 whatever the logits' dtype, as the JAX
package casts.

``group``: over a process group (data parallelism) each rank holds a
slice of the global batch, and the JAX package's loss is the mean over
the global batch. The denominator (a count of pixels, or a weight sum) is
then all-reduced first, without gradient, and each rank returns its
``local sum / global denominator`` times the group's size: the mean of
the ranks' values, and of their gradients, is the global mean's.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F


def _mean(total, denom, group=None):
    """total / max(denom, 1); over ``group``, with the denominator summed
    over the ranks and the result scaled by the group's size."""
    if group is None:
        return total / torch.clamp(denom, min=1.0)
    denom = denom.detach().float().clone()
    dist.all_reduce(denom, group=group)
    return total / torch.clamp(denom, min=1.0) * dist.get_world_size(group)


def cross_entropy_loss(logits, labels, ignore_index: int = 255,
                       weight=None, group=None):
    """Mean CE over the pixels whose label is not ``ignore_index``:
    total / max(count, 1), so an all-ignored mask gives exactly 0 (where
    ``F.cross_entropy(reduction="mean")`` gives NaN). ``weight`` is an
    optional per-class weight; the denominator is then the summed weight
    of the valid pixels."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    if weight is not None:
        w = torch.as_tensor(weight, dtype=torch.float32,
                            device=logits.device)[safe]
        nll = nll * w
        denom = torch.where(valid, w, torch.zeros_like(w)).sum()
    else:
        denom = valid.sum().float()
    total = torch.where(valid, nll, torch.zeros_like(nll)).sum()
    return _mean(total, denom, group)


def negative_learning_loss(probs, threshold: float = 0.05, group=None):
    """-mean over {p < threshold} of log(1 - p + 1e-6), the mask taken
    without gradient."""
    p = probs.float()
    mask = (p < threshold).float().detach()
    item = -mask * torch.log(1.0 - p + 1e-6)
    return _mean(item.sum(), mask.sum(), group)


def _box_mean_3x3(p, neighbor: int = 8):
    """3x3 (neighbor 8) or plus-shaped (neighbor 4) mean with replicate
    padding, over channel-last maps."""
    xp = F.pad(p.permute(0, 3, 1, 2), (1, 1, 1, 1),
               mode="replicate").permute(0, 2, 3, 1)
    if neighbor == 8:
        rows = xp[:, :-2] + xp[:, 1:-1] + xp[:, 2:]
        return (rows[:, :, :-2] + rows[:, :, 1:-1] + rows[:, :, 2:]) / 9.0
    if neighbor == 4:
        return (xp[:, 1:-1, 1:-1] + xp[:, :-2, 1:-1] + xp[:, 2:, 1:-1]
                + xp[:, 1:-1, :-2] + xp[:, 1:-1, 2:]) / 5.0
    raise NotImplementedError(neighbor)


def local_discrepancy(logits, l_type: str = "l1", neighbor: int = 8):
    """Per-pixel discrepancy (N, H, W) between the softmax and its 3x3
    neighbour mean."""
    p = F.softmax(logits.float(), dim=-1)
    mean = _box_mean_3x3(p, neighbor)
    if l_type == "l1":
        return (p - mean).abs().sum(dim=-1)
    if l_type == "kl":
        return (p * torch.log(p / (mean + 1e-6) + 1e-6)).sum(dim=-1)
    raise NotImplementedError(f"not implemented local soft loss: {l_type}")


def semantic_boundary(labels, neighbor: int = 8):
    """True where the label map's 8- (or 4-) neighbour Laplacian with zero
    padding is nonzero: the pixel touches another label."""
    x = labels.long()
    xp = F.pad(x, (1, 1, 1, 1))
    if neighbor == 8:
        neigh = (xp[:, :-2, :-2] + xp[:, :-2, 1:-1] + xp[:, :-2, 2:]
                 + xp[:, 1:-1, :-2] + xp[:, 1:-1, 2:]
                 + xp[:, 2:, :-2] + xp[:, 2:, 1:-1] + xp[:, 2:, 2:])
        lap = 8 * x - neigh
    elif neighbor == 4:
        neigh = (xp[:, :-2, 1:-1] + xp[:, 2:, 1:-1]
                 + xp[:, 1:-1, :-2] + xp[:, 1:-1, 2:])
        lap = 4 * x - neigh
    else:
        raise NotImplementedError(neighbor)
    return lap != 0


def local_consistent_loss(logits, labels, l_type: str = "l1",
                          ignore_index: int = 255, group=None):
    """Mean local discrepancy over the semantic-boundary pixels that are
    not ignored (0 when there are none)."""
    disc = local_discrepancy(logits, l_type=l_type)
    m = (semantic_boundary(labels) & (labels != ignore_index)).float()
    return _mean((disc * m).sum(), m.sum(), group)
