"""DeepLab-v2 and v3+ segmentation heads, Euclidean and hyperbolic, in
PyTorch.

Port of ``halo_tpu/models/classifier.py``: ``ASPPv2Head``,
``ASPPv2HyperHead``, ``SeparableASPPHead`` and ``SeparableASPPHyperHead``,
with their parts ``_ASPPDecoder`` (``ASPPDecoder``), ``HFRNorm``
(``hfr_norm``) and ``HyperMLRHead`` (``HyperMLR``). Modules run NCHW
internally and return channel-last ``(logits, aux)``; parameter names are
the upstream torch heads' (``conv2d_list.*``, ``parallel_branches.*``,
``global_branch.*``, ``bottleneck.*``, ``shortcut.*``, ``decoder.*``,
``cls_conv``, ``conv_reduce``, ``wn_mlp.*``, ``conv_seg.P_MLR``/``A_MLR``).

dtype boundaries follow the JAX heads: convs run in the autocast dtype
(bf16 under ``TPU.COMPUTE_DTYPE bfloat16``), so the Euclidean heads' logits
come out in it, while HFR, ``expmap`` and the MLR run in float32 with
autocast off.

``quant`` (the int8 build, ``TPU.QUANT_EVAL``) makes the v3+ decoder's
ConvBNReLU convs (the 1x1 branch, the global branch, the 3x3
``bottleneck``, the ``shortcut``) and its separable convs' pointwise 1x1s
``QuantConv``s. The depthwise convs, ``conv_reduce``, the class convs, the
v2 ASPP convs, HFR's MLP and the MLR stay float.
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


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _init_head_(head: nn.Module, generator: torch.Generator):
    """Kaiming-normal fan_in convs with torch-default biases,
    torch-default Linear layers, U(+-1/sqrt(C)) MLR params and identity
    norms, as the JAX heads initialise; ``conv2d_list`` (the v2 ASPP
    convs) takes N(0, 0.01) kernels."""
    aspp = set(getattr(head, "conv2d_list", ()))
    for mod in head.modules():
        if mod in aspp:
            with torch.no_grad():
                mod.weight.normal_(0.0, 0.01, generator=generator)
            uniform_fan_in_(mod.bias, mod.weight[0].numel(), generator)
        elif isinstance(mod, nn.Conv2d):
            init_conv_(mod, "fan_in", generator)
        elif isinstance(mod, nn.Linear):
            uniform_fan_in_(mod.weight, mod.in_features, generator)
            uniform_fan_in_(mod.bias, mod.in_features, generator)
        elif isinstance(mod, HyperMLR):
            channels = mod.P_MLR.shape[1]
            uniform_fan_in_(mod.P_MLR, channels, generator)
            uniform_fan_in_(mod.A_MLR, channels, generator)
    reset_norms_(head)


def _aspp_convs(out_channels: int, dilations, in_channels: int):
    """The DeepLab-v2 ASPP's dilated 3x3 convs with bias."""
    return nn.ModuleList(
        nn.Conv2d(in_channels, out_channels, 3, padding=d, dilation=d,
                  bias=True) for d in dilations)


def _aspp_sum(convs, x):
    """The sum of the ASPP convs of ``x``, in order."""
    out = None
    for conv in convs:
        y = conv(x)
        out = y if out is None else out + y
    return out


class ASPPDecoder(nn.Module):
    """ASPP branches + global branch + bottleneck + low-level shortcut +
    two separable decoder convs -> 512-ch map at the resolution of the
    trunk's ``low`` map; ``in_channels`` and ``low_channels`` are the
    widths of the trunk's ``out`` and ``low`` maps."""

    def __init__(self, freeze_bn: bool = False, in_channels: int = 2048,
                 low_channels: int = 256, quant: bool = False):
        super().__init__()
        cin, low, out, short = in_channels, low_channels, 512, 48
        opts = dict(freeze_bn=freeze_bn, quant=quant)
        self.parallel_branches = nn.ModuleList(
            [ConvBNReLU(cin, out, 1, **opts)]
            + [DepthwiseSeparableConv(cin, out, dilation=d, **opts)
               for d in (6, 12, 18)])
        # AdaptiveAvgPool2d at index 0, as in the upstream Sequential.
        gb = ConvBNReLU(cin, out, 1, **opts)
        self.global_branch = nn.Sequential(nn.AdaptiveAvgPool2d(1), *gb)
        self.bottleneck = ConvBNReLU(5 * out, out, 3, padding=1, **opts)
        self.shortcut = ConvBNReLU(low, short, 1, **opts)
        self.decoder = nn.Sequential(
            DepthwiseSeparableConv(out + short, out, **opts),
            DepthwiseSeparableConv(out, out, **opts))

    def forward(self, feats):
        low, x = feats["low"], feats["out"]
        branches = [b(x) for b in self.parallel_branches]
        g = self.global_branch(x)
        # align-corners upsample of a 1x1 map is a broadcast
        branches.append(g.expand(-1, -1, x.shape[2], x.shape[3]))
        y = self.bottleneck(torch.cat(branches, dim=1))
        y = _resize_nchw(y, low.shape[2:])
        y = torch.cat([y, self.shortcut(low)], dim=1)
        return self.decoder[1](self.decoder[0](y))


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
                 freeze_bn: bool = False, in_channels: int = 2048,
                 low_channels: int = 256, quant: bool = False):
        super().__init__(freeze_bn, in_channels, low_channels, quant)
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

    init_weights = _init_head_


class ASPPv2Head(nn.Module):
    """DeepLab-v2 ASPP: the sum of four dilated 3x3 convs (d = 6, 12, 18,
    24) straight to the class logits. Returns ``(logits, None)``, logits
    upsampled to ``size`` when given."""

    def __init__(self, num_classes: int, dilations=(6, 12, 18, 24),
                 in_channels: int = 2048):
        super().__init__()
        self.conv2d_list = _aspp_convs(num_classes, dilations, in_channels)

    def forward(self, feats, size: Optional[Tuple[int, int]] = None):
        x = feats["out"]
        out = _nhwc(_aspp_sum(self.conv2d_list, x))
        if size is not None:
            out = resize_bilinear(out, size)
        return out, None

    init_weights = _init_head_


class ASPPv2HyperHead(nn.Module):
    """DeepLab-v2 ASPP to ``reduced_channels`` -> expmap -> Poincare MLR at
    feature resolution. Returns float32 ``(logits, embed)``; when ``size``
    is given both are resized to it."""

    def __init__(self, num_classes: int, reduced_channels: int = 64,
                 curvature: float = 1.0, dilations=(6, 12, 18, 24),
                 in_channels: int = 2048):
        super().__init__()
        self.curvature = curvature
        self.conv2d_list = _aspp_convs(reduced_channels, dilations,
                                       in_channels)
        self.conv_seg = HyperMLR(num_classes, reduced_channels, c=curvature)

    def forward(self, feats, size: Optional[Tuple[int, int]] = None):
        x = feats["out"]
        y = _aspp_sum(self.conv2d_list, x)
        with torch.autocast(y.device.type, enabled=False):
            embed = hyp.expmap(_nhwc(y.float()), c=self.curvature)
            out = self.conv_seg(embed)
            if size is not None:
                out = resize_bilinear(out, size)
                embed = resize_bilinear(embed, size)
        return out, embed

    init_weights = _init_head_


class SeparableASPPHead(ASPPDecoder):
    """DeepLab-v3+ Euclidean head. With ``reduced_channels`` 512 and no HFR
    it takes the upstream ``old_decoder`` layout: channel Dropout2d and
    the 1x1 class conv appended to ``decoder`` (``decoder.2``,
    ``decoder.3``); otherwise an optional 1x1 ``conv_reduce``, optional
    HFR (float32), element-wise Dropout and ``cls_conv``. Returns
    channel-last ``(logits, decoder_out)``: logits upsampled to ``size``
    when given, ``decoder_out`` the features the classifier reads (after
    reduce and HFR), at feature resolution."""

    def __init__(self, num_classes: int, reduced_channels: int = 512,
                 hfr: bool = False, freeze_bn: bool = False,
                 in_channels: int = 2048, low_channels: int = 256,
                 quant: bool = False):
        super().__init__(freeze_bn, in_channels, low_channels, quant)
        self.old_decoder = reduced_channels == 512 and not hfr
        if self.old_decoder:
            self.decoder.append(nn.Dropout2d(0.1))
            self.decoder.append(nn.Conv2d(512, num_classes, 1, bias=True))
            self.dropout = self.decoder[2]
            return
        self.conv_reduce = (nn.Conv2d(512, reduced_channels, 1, bias=True)
                            if reduced_channels != 512 else None)
        self.wn_mlp = make_wn_mlp(reduced_channels) if hfr else None
        self.dropout = nn.Dropout(0.1)
        self.cls_conv = nn.Conv2d(reduced_channels, num_classes, 1,
                                  bias=True)

    def forward(self, feats, size: Optional[Tuple[int, int]] = None):
        y = super().forward(feats)
        if self.old_decoder:
            decoder_out = y
            out = self.decoder[3](self.dropout(y))
        else:
            if self.conv_reduce is not None:
                y = self.conv_reduce(y)
            if self.wn_mlp is not None:
                with torch.autocast(y.device.type, enabled=False):
                    y = hfr_norm(y.float(), self.wn_mlp)
            decoder_out = y
            out = self.cls_conv(self.dropout(y))
        out = _nhwc(out)
        if size is not None:
            out = resize_bilinear(out, size)
        return out, _nhwc(decoder_out)

    init_weights = _init_head_
