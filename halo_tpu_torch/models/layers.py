"""Normalization and conv blocks of the model zoo, in PyTorch.

Port of the semantic layers of ``halo_tpu/models/layers.py``:
FrozenBatchNorm, the live BatchNorm with torch momentum, ``make_norm``,
ConvBNReLU, DepthwiseSeparableConv, the dilated trunk conv that runs
kernel C (``DilatedConv3x3``, the counterpart of ``PallasDilatedConv``),
and the int8 (W8A8) evaluation layers ``QuantConv`` and ``QuantDense``
with their build rules (``quant_eligible``, ``make_conv``, ``make_dense``;
``ops/quant.py`` holds their arithmetic). Other convolutions are
``nn.Conv2d`` (cuDNN on a GPU; ``groups=C`` for depthwise). The JAX
package's other conv lowerings (stencils, shifted GEMMs, space-to-batch,
GEMM weight grads) are choices for the TPU's compiler, not semantics, and
have no counterpart here.

Module and buffer names follow the upstream torch checkpoints, so a
reference ``state_dict`` loads with ``strict=True``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops import quant as quant_ops
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
        self._affine = {}

    def _scale_shift(self):
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        return scale, self.bias - self.running_mean * scale

    def forward(self, x):
        scale, shift = self._scale_shift()
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return (x * scale.to(x.dtype).view(shape)
                + shift.to(x.dtype).view(shape))

    def affine(self, dtype):
        """``forward``'s (scale, shift) in ``dtype``, contiguous (C,): what
        kernel Q's prologue applies in its place. Made once a dtype and
        kept until a buffer is replaced or changed in place (its version
        moves: ``load_state_dict``, ``reset_norms_``)."""
        bufs = (self.weight, self.bias, self.running_mean, self.running_var)
        versions = tuple(b._version for b in bufs)
        kept = self._affine.get(dtype)
        if kept is None or kept[1] != versions or any(
                a is not b for a, b in zip(kept[0], bufs)):
            with torch.no_grad():
                scale, shift = self._scale_shift()
                kept = (bufs, versions, scale.to(dtype).contiguous(),
                        shift.to(dtype).contiguous())
            self._affine[dtype] = kept
        return kept[2], kept[3]


def make_norm(freeze_bn: bool, features: int) -> nn.Module:
    """FrozenBatchNorm2d, or the live BatchNorm2d with torch momentum 0.1
    and eps 1e-5 (the JAX package's ``layers.BatchNorm``)."""
    if freeze_bn:
        return FrozenBatchNorm2d(features)
    return nn.BatchNorm2d(features, eps=1e-5, momentum=0.1)


class ConvBNReLU(nn.Sequential):
    """Conv -> norm -> ReLU; children 0, 1, 2 as in the upstream
    ``nn.Sequential`` blocks (``bottleneck.0``, ``bottleneck.1``, ...).
    ``quant``: the conv is a ``QuantConv`` (every ConvBNReLU is stride 1
    and ungrouped)."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 padding: int = 0, freeze_bn: bool = False,
                 quant: bool = False):
        super().__init__(
            make_conv(in_features, features, kernel_size, padding=padding,
                      quant=quant),
            make_norm(freeze_bn, features),
            nn.ReLU(inplace=True))


class DepthwiseSeparableConv(nn.Module):
    """Depthwise 3x3 (+BN+ReLU) then pointwise 1x1 (+BN+ReLU); with
    ``quant`` the pointwise conv is a ``QuantConv`` and the depthwise one
    stays float."""

    def __init__(self, in_features: int, out_features: int,
                 dilation: int = 1, freeze_bn: bool = False,
                 quant: bool = False):
        super().__init__()
        self.depthwise_conv = nn.Conv2d(
            in_features, in_features, 3, padding=dilation,
            dilation=dilation, groups=in_features, bias=False)
        self.depthwise_bn = make_norm(freeze_bn, in_features)
        self.pointwise_conv = make_conv(in_features, out_features, 1,
                                        quant=quant)
        self.pointwise_bn = make_norm(freeze_bn, out_features)

    def forward(self, x):
        x = norm_relu_conv(self.pointwise_conv, self.depthwise_conv(x),
                           self.depthwise_bn, torch.relu)
        return torch.relu(self.pointwise_bn(x))


def dilated_conv_eligible(mode: str, channels: int, stride: int,
                          dilation: int, groups: int = 1) -> bool:
    """Whether a bottleneck's ``conv2`` (a 3x3 with padding = dilation and
    ``channels`` in and out) routes to kernel C
    (``TPU.DENSE_CONV_MODE "pallas"``), decided once when the module is
    built from the JAX package's structural rule
    (``halo_tpu/models/layers.py:751``): ungrouped, stride 1, dilation
    >= 2, channels a multiple of 128 (which ``ops/dilated_conv.supports``
    takes in both dtypes). The JAX rule's W % 8 and VMEM budget are TPU
    limits and are not carried over: the kernel takes any H and W."""
    return (mode == "pallas" and groups == 1 and stride == 1
            and dilation >= 2 and channels % 128 == 0)


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
# int8 W8A8 evaluation (TPU.QUANT_EVAL; halo_tpu/models/layers.py:436-676)
# ---------------------------------------------------------------------------

# Fewest output positions (per image, ceil(H/sh) * ceil(W/sw)) at which a
# STRIDED QuantConv runs int8 in eval mode; below, it runs the float conv.
# Decided per call from the input's size, as the JAX module decides per
# trace; which layers hold quantisation state depends on the architecture
# only.
_MIN_STRIDED_POSITIONS = 2048


def quant_eligible(quant: bool, stride, groups: int = 1,
                   in_features: Optional[int] = None) -> bool:
    """Whether a conv is built as a ``QuantConv``: the int8 build
    (``quant``), ungrouped, and stride 1 or a strided conv whose input has
    at least 128 channels (callers pass ``in_features`` for that).
    Depthwise convs and every logits- or embedding-producing conv stay
    float (their call sites never ask)."""
    if not quant or groups != 1:
        return False
    if stride in (1, (1, 1)):
        return True
    return in_features is not None and in_features >= 128


class QuantConv(quant_ops.QuantLayer, nn.Conv2d):
    """``nn.Conv2d`` (same parameters and names) with an int8 W8A8
    evaluation path. Its mode: training -> the float conv; calibrating
    (``ops.quant.calibrate``) -> the float conv, plus ``amax`` = running
    max|x| and the weight snapshot (``w_int8``, ``w_scale`` and kernel I's
    packed operand ``w_packed``); otherwise int8 (kernels Q and I), its
    output in the autocast dtype when autocast is on (else the input's),
    the bias added after. A strided conv with fewer than
    ``_MIN_STRIDED_POSITIONS`` output positions runs the float conv in
    every mode.

    ``forward(x, norm=None, relu=None)`` convolves ``relu(norm(x))``
    (``input_of``): ``x`` a tensor or a list of up to five (B, C_i, H, W)
    tensors concatenated along the channels, ``norm`` and ``relu`` the
    producer's norm and ReLU, pending. When the conv runs int8 and the norm
    is a ``FrozenBatchNorm2d`` (or there is none), kernel Q applies all of
    it in its one pass (``ops.quant.quantize_fused``: the concatenation
    read in place, the norm's ``affine``, the ReLU); otherwise they run as
    the modules they are, then the conv."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.groups != 1 or self.padding_mode != "zeros" or isinstance(
                self.padding, str):
            raise ValueError("QuantConv: ungrouped, zero-padded convs with "
                             "numeric padding only")
        self._init_quant()

    def _small_strided(self, x) -> bool:
        sh, sw = self.stride
        positions = -(-x.shape[-2] // sh) * -(-x.shape[-1] // sw)
        return (sh, sw) != (1, 1) and positions < _MIN_STRIDED_POSITIONS

    @staticmethod
    def input_of(x, norm=None, relu=None):
        """The tensor ``forward(x, norm, relu)`` convolves, by the unfused
        ops: the concatenation, then ``norm``, then ``relu``."""
        if isinstance(x, (list, tuple)):
            x = torch.cat(list(x), dim=1)
        if norm is not None:
            x = norm(x)
        return x if relu is None else relu(x)

    def forward(self, x, norm=None, relu=None):
        first = x[0] if isinstance(x, (list, tuple)) else x
        if self.training or self.calibrating or self._small_strided(first):
            x = self.input_of(x, norm, relu)
            y = super().forward(x)
            if self.calibrating and not self.training:
                self.observe(x)
            return y
        if not (norm is None or isinstance(norm, FrozenBatchNorm2d)):
            x = first = self.input_of(x, norm, relu)
            norm = relu = None
        dtype = self.out_dtype(first)
        scale, shift = (None, None) if norm is None else \
            norm.affine(first.dtype)
        xq = quant_ops.quantize_fused(
            x if isinstance(x, (list, tuple)) else (x,), self.amax, scale,
            shift, relu is not None)
        y = quant_ops.int8_conv_kernel(
            xq, self.w_packed, self.w_scale, self.amax, self.kernel_size,
            self.stride, self.padding, self.dilation, dtype)
        if self.bias is not None:
            y = y + self.bias.to(dtype).view(1, -1, 1, 1)
        return y


class QuantDense(quant_ops.QuantLayer, nn.Linear):
    """``nn.Linear`` (same parameters and names) with an int8 W8A8
    evaluation path over the last axis; the modes of ``QuantConv``, the
    int8 product by ``ops.quant.int8_dense`` (kernels Q and I, a one-tap
    conv over the rows)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._init_quant()

    def forward(self, x):
        if self.training or self.calibrating:
            y = super().forward(x)
            if self.calibrating and not self.training:
                self.observe(x)
            return y
        dtype = self.out_dtype(x)
        y = quant_ops.int8_dense(x, self.w_int8, self.w_scale, self.amax,
                                 out_dtype=dtype, packed=self.w_packed)
        if self.bias is not None:
            y = y + self.bias.to(dtype)
        return y


def norm_relu_conv(conv: nn.Module, x, norm: nn.Module, relu):
    """``conv(relu(norm(x)))``: a ``QuantConv`` takes the norm and the ReLU
    as kernel Q's prologue when it runs int8; any other conv gets them
    applied first."""
    if isinstance(conv, QuantConv):
        return conv(x, norm, relu)
    return conv(relu(norm(x)))


def make_conv(in_features: int, features: int, kernel_size, stride=1,
              padding=0, dilation=1, groups: int = 1, bias: bool = False,
              quant: bool = False) -> nn.Conv2d:
    """``nn.Conv2d``, or a ``QuantConv`` when ``quant_eligible`` holds
    (every strided call site of the JAX package hands the rule its input
    width, as this one does)."""
    if quant_eligible(quant, stride, groups, in_features):
        return QuantConv(in_features, features, kernel_size, stride=stride,
                         padding=padding, dilation=dilation, bias=bias)
    return nn.Conv2d(in_features, features, kernel_size, stride=stride,
                     padding=padding, dilation=dilation, groups=groups,
                     bias=bias)


def make_dense(in_features: int, features: int, bias: bool = True,
               quant: bool = False, min_cin: int = 128) -> nn.Linear:
    """``nn.Linear``, or a ``QuantDense`` in an int8 build when the input
    has at least ``min_cin`` channels (narrower layers stay float and hold
    no quantisation state, as the JAX ``QuantDense``'s narrow path)."""
    if quant and in_features >= min_cin:
        return QuantDense(in_features, features, bias=bias)
    return nn.Linear(in_features, features, bias=bias)


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
