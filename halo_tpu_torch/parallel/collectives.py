"""The reductions of a data-parallel train step, one implementation for
NCCL and for gloo (each is an ``all_reduce`` or a ``broadcast``, the two
collectives gloo carries on CUDA tensors).

What GSPMD inserts for the JAX package's global batch, made explicit:

  * ``all_reduce_sum``: an all-reduce (SUM) whose backward all-reduces the
    gradient, so a value built from every rank's slice differentiates as
    the one-process value does;
  * ``SyncBatchNorm1d``/``SyncBatchNorm2d``: live BatchNorm with the
    statistics of the global batch (``nn.SyncBatchNorm`` refuses CPU
    tensors); ``convert_sync_batchnorm`` swaps them in place, keeping
    every parameter, buffer and name;
  * ``all_reduce_gradients``: the mean gradient over the ranks, in
    flattened buckets, after ``backward`` and before the optimizer step;
  * ``broadcast_module``: rank 0's parameters and buffers on every rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn as nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

_BUCKET_BYTES = 32 << 20


class _AllReduceSum(torch.autograd.Function):
    """Forward: the SUM of ``x`` over the group. Backward: the SUM of the
    incoming gradients, since every rank's output depends on every rank's
    input."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x, group=None):
    """SUM of ``x`` over ``group`` (default the world), with gradients."""
    return _AllReduceSum.apply(x, group)


class _SyncBatchNorm:
    """Train-mode forward over the global batch: the mean from an
    all-reduce of (per-channel sums, pixel count), then the biased
    variance from an all-reduce of the centred squares, both with
    gradients; normalised in float32 and returned in the input's dtype.
    Running statistics as ``nn.BatchNorm`` keeps them (torch momentum,
    the unbiased variance over the global count). Eval mode reads the
    running statistics, which every rank holds alike."""

    process_group = None

    def forward(self, x):
        self._check_input_dim(x)
        if not self.training:
            return super().forward(x)
        dims = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        xf = x.float()
        count = torch.full((1,), float(x.numel() // x.shape[1]),
                           device=x.device)
        sums = all_reduce_sum(torch.cat([xf.sum(dims), count]),
                              self.process_group)
        n = sums[-1]
        mean = sums[:-1] / n
        xc = xf - mean.view(shape)
        var = all_reduce_sum((xc * xc).sum(dims), self.process_group) / n
        y = xc * torch.rsqrt(var + self.eps).view(shape)
        if self.affine:
            y = y * self.weight.view(shape) + self.bias.view(shape)
        if self.track_running_stats:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(mean.detach() * m)
                unbiased = var.detach() * (n / torch.clamp(n - 1, min=1))
                self.running_var.mul_(1 - m).add_(unbiased * m)
        return y.to(x.dtype)


class SyncBatchNorm1d(_SyncBatchNorm, nn.BatchNorm1d):
    pass


class SyncBatchNorm2d(_SyncBatchNorm, nn.BatchNorm2d):
    pass


_SYNCED = {nn.BatchNorm1d: SyncBatchNorm1d, nn.BatchNorm2d: SyncBatchNorm2d}


def convert_sync_batchnorm(model: nn.Module, group=None) -> int:
    """Make every live ``nn.BatchNorm1d``/``nn.BatchNorm2d`` of ``model`` a
    synced one over ``group``, in place (its class swapped: parameters,
    buffers, names and the optimizer's references stay); returns how many.
    FrozenBatchNorm needs no statistics and stays."""
    n = 0
    for mod in model.modules():
        synced = _SYNCED.get(type(mod))
        if synced is not None:
            mod.__class__ = synced
            mod.process_group = group
            n += 1
    return n


def _buckets(tensors):
    """Consecutive runs of one dtype and device, of at most
    ``_BUCKET_BYTES`` each (a larger tensor is a bucket of its own)."""
    bucket, size = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if bucket and (t.dtype != bucket[0].dtype
                       or t.device != bucket[0].device
                       or size + nbytes > _BUCKET_BYTES):
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += nbytes
    if bucket:
        yield bucket


def _scatter(flat, bucket):
    """Copy a flattened bucket back into its tensors. A bucket of one
    contiguous tensor is flattened as a view of it, already written."""
    for t, part in zip(bucket, _unflatten_dense_tensors(flat, bucket)):
        if part.data_ptr() != t.data_ptr():
            t.copy_(part)


def all_reduce_gradients(parameters, group=None):
    """Replace each gradient by its mean over the group: SUM over
    flattened buckets, divided by the group's size. Every rank then takes
    the same optimizer step on bit-identical parameters."""
    n = dist.get_world_size(group)
    grads = [p.grad for p in parameters if p.grad is not None]
    for bucket in _buckets(grads):
        flat = _flatten_dense_tensors(bucket)
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        _scatter(flat, bucket)


def all_reduce_mean(values, group=None):
    """The mean over the group of a list of scalar tensors, as one
    stacked all-reduce; returns the list of means."""
    stacked = torch.stack([v.detach().float() for v in values])
    dist.all_reduce(stacked, group=group)
    return list((stacked / dist.get_world_size(group)).unbind())


@torch.no_grad()
def broadcast_module(model: nn.Module, group=None, src: int = 0):
    """Rank ``src``'s parameters and persistent buffers on every rank, in
    flattened buckets."""
    tensors = [t for t in model.state_dict().values()
               if t is not None and t.numel()]
    for bucket in _buckets(tensors):
        flat = _flatten_dense_tensors(bucket)
        dist.broadcast(flat, src=src, group=group)
        _scatter(flat, bucket)
