"""Normalization and conv blocks of the model zoo, in PyTorch.

Port of the semantic layers of ``halo_tpu/models/layers.py``:
FrozenBatchNorm, the live BatchNorm with torch momentum, ``make_norm``,
ConvBNReLU, DepthwiseSeparableConv, and the dilated trunk conv that runs
kernel C (``DilatedConv3x3``, the counterpart of ``PallasDilatedConv``).
Other convolutions are ``nn.Conv2d`` (cuDNN on a GPU; ``groups=C`` for
depthwise). The JAX package's other conv lowerings (stencils, shifted
GEMMs, space-to-batch, GEMM weight grads, int8) are choices for the TPU's
compiler, not semantics, and have no counterpart here.

Module and buffer names follow the upstream torch checkpoints, so a
reference ``state_dict`` loads with ``strict=True``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.dilated_conv import dilated_conv3x3


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


def dilated_conv_eligible(mode: str, channels: int, stride: int,
                          dilation: int) -> bool:
    """Whether a bottleneck's ``conv2`` (a dense, ungrouped 3x3 with
    padding = dilation and ``channels`` in and out) routes to kernel C
    (``TPU.DENSE_CONV_MODE "pallas"``), decided once when the module is
    built from the JAX package's structural rule
    (``halo_tpu/models/layers.py:751``): stride 1, dilation >= 2, channels
    a multiple of 128 (which ``ops/dilated_conv.supports`` takes in both
    dtypes). The JAX rule's W % 8 and VMEM budget are TPU limits and are
    not carried over: the kernel takes any H and W."""
    return (mode == "pallas" and stride == 1 and dilation >= 2
            and channels % 128 == 0)


class DilatedConv3x3(nn.Conv2d):
    """A bias-free 3x3 stride-1 conv with padding = dilation = d that runs
    kernel C (``ops/dilated_conv.py``) forward and backward. It keeps the
    ``weight`` parameter of ``nn.Conv2d`` (float32, ``(Co, C, 3, 3)``), so
    names and checkpoints are those of the conv it replaces. Input and
    weight are cast to the autocast dtype when autocast is on, else to the
    input's dtype, as the JAX module casts to its compute dtype."""

    def __init__(self, in_channels: int, out_channels: int, dilation: int):
        super().__init__(in_channels, out_channels, 3, padding=dilation,
                         dilation=dilation, bias=False)

    def forward(self, x):
        kind = x.device.type
        dtype = (torch.get_autocast_dtype(kind)
                 if torch.is_autocast_enabled(kind) else x.dtype)
        return dilated_conv3x3(x.to(dtype), self.weight.to(dtype),
                               self.dilation[0])


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
