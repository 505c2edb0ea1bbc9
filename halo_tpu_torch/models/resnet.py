"""Dilated ResNet backbones (output stride 8) in PyTorch.

Port of ``halo_tpu/models/resnet.py``: torchvision-style Bottleneck ResNet
with ``replace_stride_with_dilation=(False, True, True)``, returning the
``{'low': layer1, 'out': layer4}`` feature pyramid. Parameter names are
torchvision's (``layer3.7.conv2.weight``, ``layer1.0.downsample.0``), so an
ImageNet checkpoint's keys line up.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .layers import (DilatedConv3x3, dilated_conv_eligible, init_conv_,
                     make_norm, reset_norms_)


class Bottleneck(nn.Module):
    """1x1 reduce -> 3x3 (stride/dilation) -> 1x1 expand, residual add.

    ``dense_conv_mode`` "pallas" builds an eligible 3x3 as a
    ``DilatedConv3x3`` (kernel C); any other mode keeps ``nn.Conv2d``."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, has_downsample: bool = False,
                 freeze_bn: bool = False, dense_conv_mode: str = "conv"):
        super().__init__()
        out_ch = planes * self.expansion
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = make_norm(freeze_bn, planes)
        if dilated_conv_eligible(dense_conv_mode, planes, stride, dilation):
            self.conv2 = DilatedConv3x3(planes, planes, dilation)
        else:
            self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride,
                                   padding=dilation, dilation=dilation,
                                   bias=False)
        self.bn2 = make_norm(freeze_bn, planes)
        self.conv3 = nn.Conv2d(planes, out_ch, 1, bias=False)
        self.bn3 = make_norm(freeze_bn, out_ch)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if has_downsample:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, out_ch, 1, stride=stride, bias=False),
                make_norm(freeze_bn, out_ch))

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return self.relu(y + identity)


class ResNetFeatures(nn.Module):
    """ResNet trunk returning ``{'low', 'out'}``.

    Dilation bookkeeping follows torchvision ``_make_layer``: when a stage
    dilates, its first block keeps the previous dilation with stride 1 and
    the later blocks use the multiplied dilation.
    """

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 23, 3),
                 replace_stride_with_dilation=(False, True, True),
                 freeze_bn: bool = False, dense_conv_mode: str = "conv"):
        super().__init__()
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
                    has_downsample=first and (
                        stride != 1 or inplanes != planes * 4),
                    freeze_bn=freeze_bn, dense_conv_mode=dense_conv_mode))
                inplanes = planes * Bottleneck.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*layer))

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        low = self.layer1(x)
        out = self.layer4(self.layer3(self.layer2(low)))
        return {"low": low, "out": out}

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

    def init_weights(self, generator: torch.Generator):
        self.backbone.init_weights(generator)


_STAGE_SIZES = {
    "resnettiny": (1, 1, 1, 1),  # test/debug-scale arch
    "resnet101": (3, 4, 23, 3),
}


def resnet_feature_extractor(backbone_name: str, freeze_bn: bool = False,
                             dense_conv_mode: str = "conv"
                             ) -> FeatureExtractor:
    """The trunk under ``feature_extractor.backbone``; ``dense_conv_mode``
    is ``TPU.DENSE_CONV_MODE`` ("pallas" routes the eligible dilated 3x3
    convs to kernel C)."""
    if backbone_name not in _STAGE_SIZES:
        raise NotImplementedError(
            f"Backbone {backbone_name!r} is not ported yet (ROADMAP.md "
            "Queue 1 item 12); the port has resnet101 and resnettiny.")
    return FeatureExtractor(ResNetFeatures(
        stage_sizes=_STAGE_SIZES[backbone_name], freeze_bn=freeze_bn,
        dense_conv_mode=dense_conv_mode))
