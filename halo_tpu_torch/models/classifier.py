"""DeepLab-v3+ hyperbolic segmentation head in PyTorch.

Port of ``SeparableASPPHyperHead`` and its parts from
``halo_tpu/models/classifier.py``: ``_ASPPDecoder`` (``ASPPDecoder``),
``HFRNorm`` (``hfr_norm``) and ``HyperMLRHead`` (``HyperMLR``).
Modules run NCHW internally; parameter names are the upstream torch
head's (``parallel_branches.*``, ``global_branch.*``, ``bottleneck.*``,
``shortcut.*``, ``decoder.*``, ``conv_reduce``, ``wn_mlp.*``,
``conv_seg.P_MLR``/``A_MLR``).

dtype boundaries follow the JAX head: the decoder runs in the autocast
dtype (bf16 under ``TPU.COMPUTE_DTYPE bfloat16``), while HFR, ``expmap`` and
the MLR run in float32 with autocast off.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops import hyperbolic as hyp
from ..ops.resize import resize_bilinear
from .layers import (ConvBNReLU, DepthwiseSeparableConv, init_conv_,
                     reset_norms_, uniform_fan_in_)


def _resize_nchw(x, out_hw):
    """Channel-last resize_bilinear applied to an NCHW tensor."""
    return resize_bilinear(x.permute(0, 2, 3, 1), out_hw).permute(0, 3, 1, 2)


class ASPPDecoder(nn.Module):
    """ASPP branches + global branch + bottleneck + low-level shortcut +
    two separable decoder convs -> 512-ch map at the stride-4 resolution."""

    def __init__(self, freeze_bn: bool = False):
        super().__init__()
        cin, low, out, short = 2048, 256, 512, 48
        self.parallel_branches = nn.ModuleList(
            [ConvBNReLU(cin, out, 1, freeze_bn=freeze_bn)]
            + [DepthwiseSeparableConv(cin, out, dilation=d,
                                      freeze_bn=freeze_bn)
               for d in (6, 12, 18)])
        # AdaptiveAvgPool2d at index 0, as in the upstream Sequential.
        gb = ConvBNReLU(cin, out, 1, freeze_bn=freeze_bn)
        self.global_branch = nn.Sequential(nn.AdaptiveAvgPool2d(1), *gb)
        self.bottleneck = ConvBNReLU(5 * out, out, 3, padding=1,
                                     freeze_bn=freeze_bn)
        self.shortcut = ConvBNReLU(low, short, 1, freeze_bn=freeze_bn)
        self.decoder = nn.Sequential(
            DepthwiseSeparableConv(out + short, out, freeze_bn=freeze_bn),
            DepthwiseSeparableConv(out, out, freeze_bn=freeze_bn))

    def forward(self, feats):
        low, x = feats["low"], feats["out"]
        branches = [b(x) for b in self.parallel_branches]
        g = self.global_branch(x)
        # align-corners upsample of a 1x1 map is a broadcast
        branches.append(g.expand(-1, -1, x.shape[2], x.shape[3]))
        y = self.bottleneck(torch.cat(branches, dim=1))
        y = _resize_nchw(y, low.shape[2:])
        y = torch.cat([y, self.shortcut(low)], dim=1)
        return self.decoder(y)


def make_wn_mlp(channels: int) -> nn.Sequential:
    """HFR's per-pixel MLP: Linear, BatchNorm1d over all pixels, ReLU,
    Linear (upstream ``wn_mlp``)."""
    return nn.Sequential(
        nn.Linear(channels, channels),
        nn.BatchNorm1d(channels, eps=1e-5, momentum=0.1),
        nn.ReLU(inplace=True),
        nn.Linear(channels, channels))


def hfr_norm(x, wn_mlp: nn.Module):
    """Hyperbolic Feature Reweighting (``HFRNorm`` of the JAX head) on an
    NCHW map: per-channel mean of ``wn_mlp`` over the pixels (clamped
    >= 1e-5) times the per-channel spatially L2-normalised features."""
    b, c, h, w = x.shape
    pix = x.permute(0, 2, 3, 1).reshape(-1, c)
    y = wn_mlp(pix).reshape(b, h * w, c)
    weights = torch.clamp(y.mean(dim=1), min=1e-5)          # (B, C)
    sq = torch.sum(x * x, dim=(2, 3), keepdim=True)
    xn = x / torch.sqrt(torch.clamp(sq, min=1e-24))
    return xn * weights[:, :, None, None]


class HyperMLR(nn.Module):
    """Poincare-ball MLR over channel-last maps; ``P_MLR``/``A_MLR`` are
    (num_classes, C) like the upstream ``conv_seg``."""

    def __init__(self, num_classes: int, channels: int, c: float = 1.0):
        super().__init__()
        self.c = c
        self.P_MLR = nn.Parameter(torch.empty(num_classes, channels))
        self.A_MLR = nn.Parameter(torch.empty(num_classes, channels))

    def forward(self, x_ball):
        return hyp.hyper_mlr_logits(x_ball.float(), self.P_MLR, self.A_MLR,
                                    c=self.c)


class SeparableASPPHyperHead(ASPPDecoder):
    """decoder -> Dropout2d -> 1x1 reduce -> HFR -> expmap -> Poincare MLR.

    The decoder's modules sit at the head's top level and ``wn_mlp`` beside
    them, as in the upstream checkpoints. Returns channel-last
    ``(logits, embed)``: logits upsampled to ``size`` (when given), the
    ball embedding at feature resolution, both float32.
    """

    def __init__(self, num_classes: int, reduced_channels: int = 64,
                 curvature: float = 1.0, hfr: bool = True,
                 freeze_bn: bool = False):
        super().__init__(freeze_bn=freeze_bn)
        self.curvature = curvature
        self.dropout = nn.Dropout2d(0.1)
        self.conv_reduce = nn.Conv2d(512, reduced_channels, 1, bias=True)
        self.wn_mlp = make_wn_mlp(reduced_channels) if hfr else None
        self.conv_seg = HyperMLR(num_classes, reduced_channels, c=curvature)

    def forward(self, feats, size: Optional[Tuple[int, int]] = None):
        y = self.conv_reduce(self.dropout(super().forward(feats)))
        with torch.autocast(y.device.type, enabled=False):
            y = y.float()
            if self.wn_mlp is not None:
                y = hfr_norm(y, self.wn_mlp)
            embed = hyp.expmap(y.permute(0, 2, 3, 1), c=self.curvature)
            out = self.conv_seg(embed)
            if size is not None:
                out = resize_bilinear(out, size)
        return out, embed

    def init_weights(self, generator: torch.Generator):
        """Kaiming-normal fan_in convs with torch-default biases,
        torch-default Linear layers, U(+-1/sqrt(C)) MLR params and
        identity norms, as the JAX head initialises."""
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                init_conv_(mod, "fan_in", generator)
            elif isinstance(mod, nn.Linear):
                uniform_fan_in_(mod.weight, mod.in_features, generator)
                uniform_fan_in_(mod.bias, mod.in_features, generator)
        channels = self.conv_seg.P_MLR.shape[1]
        uniform_fan_in_(self.conv_seg.P_MLR, channels, generator)
        uniform_fan_in_(self.conv_seg.A_MLR, channels, generator)
        reset_norms_(self)
