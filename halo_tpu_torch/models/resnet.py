"""Dilated ResNet and ResNeXt backbones (output stride 8) in PyTorch.

Port of ``halo_tpu/models/resnet.py``: torchvision-style Bottleneck ResNet
with ``replace_stride_with_dilation=(False, True, True)``, returning the
``{'low': layer1, 'out': layer4}`` feature pyramid. Parameter names are
torchvision's (``layer3.7.conv2.weight``, ``layer1.0.downsample.0``), so an
ImageNet checkpoint's keys line up. ResNeXt's grouped 3x3 convs stay
``nn.Conv2d`` (cuDNN): kernel C takes ungrouped convs only.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .layers import (DilatedConv3x3, QuantConv, dilated_conv_eligible,
                     init_conv_, make_conv, make_norm, quant_eligible,
                     reset_norms_)


class Bottleneck(nn.Module):
    """1x1 reduce -> 3x3 (stride/dilation, ``groups``) -> 1x1 expand,
    residual add; the inner width is ``planes * base_width / 64 * groups``.

    ``dense_conv_mode`` "pallas" builds an eligible 3x3 as a
    ``DilatedConv3x3`` (kernel C); any other mode keeps ``nn.Conv2d``.
    ``quant`` (the int8 build) makes the 1x1s, the downsample and an
    eligible 3x3 ``QuantConv``s; the int8 rule comes first, so a quantised
    build never routes a conv to kernel C."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, groups: int = 1, base_width: int = 64,
                 has_downsample: bool = False, freeze_bn: bool = False,
                 dense_conv_mode: str = "conv", quant: bool = False):
        super().__init__()
        out_ch = planes * self.expansion
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = make_conv(inplanes, width, 1, quant=quant)
        self.bn1 = make_norm(freeze_bn, width)
        if quant_eligible(quant, stride, groups, in_features=width):
            self.conv2 = QuantConv(width, width, 3, stride=stride,
                                   padding=dilation, dilation=dilation,
                                   bias=False)
        elif dilated_conv_eligible(dense_conv_mode, width, stride, dilation,
                                   groups):
            self.conv2 = DilatedConv3x3(width, width, dilation)
        else:
            self.conv2 = nn.Conv2d(width, width, 3, stride=stride,
                                   padding=dilation, dilation=dilation,
                                   groups=groups, bias=False)
        self.bn2 = make_norm(freeze_bn, width)
        self.conv3 = make_conv(width, out_ch, 1, quant=quant)
        self.bn3 = make_norm(freeze_bn, out_ch)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if has_downsample:
            self.downsample = nn.Sequential(
                make_conv(inplanes, out_ch, 1, stride=stride, quant=quant),
                make_norm(freeze_bn, out_ch))

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return self.relu(y + identity)


@contextlib.contextmanager
def _keep_running_stats(module: nn.Module):
    """Restore every live BatchNorm's running buffers of ``module`` on the
    way out, so the recompute of a checkpointed block leaves them as the
    forward left them (JAX's functional remat never updates them twice)."""
    saved = [(buf, buf.clone()) for mod in module.modules()
             if isinstance(mod, nn.modules.batchnorm._BatchNorm)
             for buf in (mod.running_mean, mod.running_var,
                         mod.num_batches_tracked) if buf is not None]
    try:
        yield
    finally:
        with torch.no_grad():
            for buf, value in saved:
                buf.copy_(value)


def _remat(block: nn.Module, x):
    """``block(x)`` with its activations recomputed in the backward pass
    (``torch.utils.checkpoint``, non-reentrant, RNG state preserved)."""
    return checkpoint(block, x, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          _keep_running_stats(block)))


class ResNetFeatures(nn.Module):
    """ResNet trunk returning ``{'low', 'out'}``.

    Dilation bookkeeping follows torchvision ``_make_layer``: when a stage
    dilates, its first block keeps the previous dilation with stride 1 and
    the later blocks use the multiplied dilation. ``remat``
    (``TPU.REMAT``) recomputes each block's activations in the backward
    pass when gradients are on. ``quant`` builds the int8 evaluation
    layers (the stem stays float).
    """

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 23, 3),
                 replace_stride_with_dilation=(False, True, True),
                 groups: int = 1, base_width: int = 64,
                 freeze_bn: bool = False, dense_conv_mode: str = "conv",
                 remat: bool = False, quant: bool = False):
        super().__init__()
        self.remat = remat
        # widths of the maps the heads read
        self.channels = {"low": 64 * Bottleneck.expansion,
                         "out": 512 * Bottleneck.expansion}
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = make_norm(freeze_bn, 64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes, dilation = 64, 1
        for stage, (planes, blocks) in enumerate(
                zip((64, 128, 256, 512), stage_sizes)):
            stride = 1 if stage == 0 else 2
            previous_dilation = dilation
            if stage > 0 and replace_stride_with_dilation[stage - 1]:
                dilation *= stride
                stride = 1
            layer = []
            for b in range(blocks):
                first = b == 0
                layer.append(Bottleneck(
                    inplanes, planes, stride=stride if first else 1,
                    dilation=previous_dilation if first else dilation,
                    groups=groups, base_width=base_width,
                    has_downsample=first and (
                        stride != 1 or inplanes != planes * 4),
                    freeze_bn=freeze_bn, dense_conv_mode=dense_conv_mode,
                    quant=quant))
                inplanes = planes * Bottleneck.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*layer))

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        feats = {}
        for stage in range(1, 5):
            for block in getattr(self, f"layer{stage}"):
                x = (_remat(block, x) if self.remat
                     and torch.is_grad_enabled() else block(x))
            if stage == 1:
                feats["low"] = x
        feats["out"] = x
        return feats

    def init_weights(self, generator: torch.Generator):
        """Kaiming-normal fan_out convs and identity norms, as the JAX
        backbone initialises."""
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                init_conv_(mod, "fan_out", generator)
        reset_norms_(self)


class FeatureExtractor(nn.Module):
    """Holds the trunk under ``backbone`` — the upstream checkpoint prefix
    ``feature_extractor.backbone.*``."""

    def __init__(self, backbone: nn.Module):
        super().__init__()
        self.backbone = backbone

    def forward(self, x):
        return self.backbone(x)

    @property
    def channels(self):
        """Widths of the trunk's maps, by name (``low``, ``out`` and, for
        MiT, ``c1``..``c4``)."""
        return self.backbone.channels

    def init_weights(self, generator: torch.Generator):
        self.backbone.init_weights(generator)


# name: (stage_sizes, groups, width_per_group)
ARCHS = {
    "resnettiny": ((1, 1, 1, 1), 1, 64),  # test/debug-scale arch
    "resnet50": ((3, 4, 6, 3), 1, 64),
    "resnet101": ((3, 4, 23, 3), 1, 64),
    "resnet152": ((3, 8, 36, 3), 1, 64),
    "resnext50_32x4d": ((3, 4, 6, 3), 32, 4),
    "resnext101_32x8d": ((3, 4, 23, 3), 32, 8),
}


def resnet_feature_extractor(backbone_name: str, freeze_bn: bool = False,
                             dense_conv_mode: str = "conv",
                             remat: bool = False, quant: bool = False
                             ) -> FeatureExtractor:
    """The trunk under ``feature_extractor.backbone``; ``dense_conv_mode``
    is ``TPU.DENSE_CONV_MODE`` ("pallas" routes the eligible dilated 3x3
    convs to kernel C), ``remat`` is ``TPU.REMAT``, ``quant`` the int8
    build (``TPU.QUANT_EVAL``)."""
    if backbone_name not in ARCHS:
        raise NotImplementedError(f"Unsupported backbone: {backbone_name}.")
    sizes, groups, width = ARCHS[backbone_name]
    return FeatureExtractor(ResNetFeatures(
        stage_sizes=sizes, groups=groups, base_width=width,
        freeze_bn=freeze_bn, dense_conv_mode=dense_conv_mode, remat=remat,
        quant=quant))
