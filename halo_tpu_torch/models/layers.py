"""Normalization and conv blocks of the model zoo, in PyTorch.

Port of the semantic layers of ``halo_tpu/models/layers.py``:
FrozenBatchNorm, the live BatchNorm with torch momentum, ``make_norm``,
ConvBNReLU and DepthwiseSeparableConv. Convolutions are ``nn.Conv2d``
(cuDNN on a GPU; ``groups=C`` for depthwise). The JAX package's conv
lowering variants (stencils, shifted GEMMs, space-to-batch, GEMM weight
grads, int8, the Pallas dilated conv) are choices for the TPU's compiler,
not semantics, and have no counterpart here.

Module and buffer names follow the upstream torch checkpoints, so a
reference ``state_dict`` loads with ``strict=True``.
"""

from __future__ import annotations

import math

import torch
from torch import nn


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm with statistics and affine params frozen as buffers:
    y = x * (w * rsqrt(var + eps)) + (b - mean * w * rsqrt(var + eps)),
    applied in the input's dtype like the JAX FrozenBatchNorm."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return (x * scale.to(x.dtype).view(shape)
                + shift.to(x.dtype).view(shape))


def make_norm(freeze_bn: bool, features: int) -> nn.Module:
    """FrozenBatchNorm2d, or the live BatchNorm2d with torch momentum 0.1
    and eps 1e-5 (the JAX package's ``layers.BatchNorm``)."""
    if freeze_bn:
        return FrozenBatchNorm2d(features)
    return nn.BatchNorm2d(features, eps=1e-5, momentum=0.1)


class ConvBNReLU(nn.Sequential):
    """Conv -> norm -> ReLU; children 0, 1, 2 as in the upstream
    ``nn.Sequential`` blocks (``bottleneck.0``, ``bottleneck.1``, ...)."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 padding: int = 0, freeze_bn: bool = False):
        super().__init__(
            nn.Conv2d(in_features, features, kernel_size, padding=padding,
                      bias=False),
            make_norm(freeze_bn, features),
            nn.ReLU(inplace=True))


class DepthwiseSeparableConv(nn.Module):
    """Depthwise 3x3 (+BN+ReLU) then pointwise 1x1 (+BN+ReLU)."""

    def __init__(self, in_features: int, out_features: int,
                 dilation: int = 1, freeze_bn: bool = False):
        super().__init__()
        self.depthwise_conv = nn.Conv2d(
            in_features, in_features, 3, padding=dilation,
            dilation=dilation, groups=in_features, bias=False)
        self.depthwise_bn = make_norm(freeze_bn, in_features)
        self.pointwise_conv = nn.Conv2d(in_features, out_features, 1,
                                        bias=False)
        self.pointwise_bn = make_norm(freeze_bn, out_features)

    def forward(self, x):
        x = torch.relu(self.depthwise_bn(self.depthwise_conv(x)))
        return torch.relu(self.pointwise_bn(self.pointwise_conv(x)))


# ---------------------------------------------------------------------------
# Seeded initialisation with the JAX package's rules
# ---------------------------------------------------------------------------

def uniform_fan_in_(t: torch.Tensor, fan_in: int, generator):
    """U(+-1/sqrt(fan_in)): torch's default Linear/conv-bias init."""
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


def init_conv_(conv: nn.Conv2d, mode: str, generator):
    """Kaiming-normal (relu gain) kernel over ``mode`` fan, torch-default
    bias: the backbone uses fan_out, the head fan_in."""
    nn.init.kaiming_normal_(conv.weight, mode=mode, nonlinearity="relu",
                            generator=generator)
    if conv.bias is not None:
        fan_in = conv.weight.shape[1] * conv.weight.shape[2] * \
            conv.weight.shape[3]
        uniform_fan_in_(conv.bias, fan_in, generator)


def reset_norms_(module: nn.Module):
    """Identity statistics and affine params on every norm layer."""
    for mod in module.modules():
        if isinstance(mod, (FrozenBatchNorm2d, nn.BatchNorm2d,
                            nn.BatchNorm1d)):
            with torch.no_grad():
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
