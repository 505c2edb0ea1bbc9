"""SegFormer in PyTorch: the Mix Transformer (MiT) trunk and its all-MLP
heads, Euclidean and hyperbolic.

Port of ``halo_tpu/models/segformer.py``: ``OverlapPatchEmbed``,
``EfficientAttention``, ``MixFFN``, ``MiTBlock``, ``MixVisionTransformer``,
``MIT_ARCHS``, ``SegFormerHead`` and ``SegFormerHyperHead``.

The trunk's parameters carry the upstream NVlabs MiT names
(``patch_embed{s}.proj``/``.norm``, ``block{s}.{i}.norm1``,
``attn.q``, a fused ``attn.kv``, ``attn.sr``, ``attn.norm``,
``attn.proj``, ``norm2``, ``mlp.fc1``, ``mlp.dwconv.dwconv``,
``mlp.fc2``, ``norm{s}``), so an ImageNet ``mit_b*.pth`` loads into it
as it is. The fused ``kv`` Linear computes the JAX package's separate
``k`` and ``v`` Dense layers: its first ``dim`` outputs are ``k``.

Inside the trunk maps are channel-last (B, H, W, C), as LayerNorm and
the Linears want them; a conv sees the NCHW view of the same memory
(``channels_last``). Numerics follow the JAX modules: LayerNorm
statistics in float32 with the output in the compute dtype (epsilon
1e-5 after a patch embed and after ``sr``, 1e-6 in the blocks and the
stage norms), the exact erf GELU, and the ``sr`` conv padded as flax pads
``SAME`` (``ceil(H/s)*s - H`` in all, half of it before) where a stage's
size does not divide by its reduction ratio. The attention is
``F.scaled_dot_product_attention`` (softmax in float32 inside the
kernel; the JAX module rounds the scores to the compute dtype before its
float32 softmax).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import hyperbolic as hyp
from ..ops.resize import resize_bilinear
from .classifier import HyperMLR
from .layers import reset_norms_, uniform_fan_in_
from .resnet import FeatureExtractor, _remat


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis with float32 statistics, returned in
    the autocast dtype (the input's dtype when autocast is off), as flax's
    ``nn.LayerNorm(dtype=compute dtype)``."""

    def forward(self, x):
        kind = x.device.type
        dtype = (torch.get_autocast_dtype(kind)
                 if torch.is_autocast_enabled(kind) else x.dtype)
        with torch.autocast(kind, enabled=False):
            y = F.layer_norm(x.float(), self.normalized_shape, self.weight,
                             self.bias, self.eps)
        return y.to(dtype)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def pad_same(x, stride: int):
    """Zero-pad an NCHW map as flax pads ``SAME`` for a kernel equal to
    its stride: ``ceil(n/s)*s - n`` rows (columns) in all, ``total // 2``
    of them before."""
    h, w = x.shape[2], x.shape[3]
    th = -h % stride
    tw = -w % stride
    if th == 0 and tw == 0:
        return x
    return F.pad(x, (tw // 2, tw - tw // 2, th // 2, th - th // 2))


class OverlapPatchEmbed(nn.Module):
    """A strided conv (kernel ``patch``, padding ``patch // 2``) then
    LayerNorm(1e-5); takes NCHW, returns channel-last."""

    def __init__(self, in_channels: int, dim: int, patch: int, stride: int):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, dim, patch, stride=stride,
                              padding=patch // 2)
        self.norm = LayerNorm(dim, eps=1e-5)

    def forward(self, x):
        return self.norm(_nhwc(self.proj(x)))


class EfficientAttention(nn.Module):
    """Multi-head attention whose keys and values come from the map
    reduced by ``sr_ratio`` (a kernel = stride = ``sr_ratio`` conv, then
    LayerNorm(1e-5)); channel-last in and out."""

    def __init__(self, dim: int, heads: int, sr_ratio: int):
        super().__init__()
        self.heads = heads
        self.sr_ratio = sr_ratio
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, stride=sr_ratio)
            self.norm = LayerNorm(dim, eps=1e-5)

    def forward(self, x):
        b, h, w, c = x.shape
        hd = c // self.heads
        q = self.q(x).reshape(b, h * w, self.heads, hd).transpose(1, 2)
        kv_in = x
        if self.sr_ratio > 1:
            kv_in = self.norm(_nhwc(self.sr(pad_same(_nchw(x),
                                                     self.sr_ratio))))
        k, v = self.kv(kv_in).reshape(b, -1, 2, self.heads, hd).unbind(2)
        out = F.scaled_dot_product_attention(q, k.transpose(1, 2),
                                             v.transpose(1, 2))
        return self.proj(out.transpose(1, 2).reshape(b, h, w, c))


class DWConv(nn.Module):
    """The depthwise 3x3 conv (with bias) of Mix-FFN on a channel-last
    map; upstream's ``mlp.dwconv.dwconv``."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, padding=1, groups=dim,
                                bias=True)

    def forward(self, x):
        return _nhwc(self.dwconv(_nchw(x)))


class MixFFN(nn.Module):
    """fc1 -> depthwise 3x3 -> exact GELU -> fc2."""

    def __init__(self, dim: int, mlp_ratio: int = 4):
        super().__init__()
        hidden = dim * mlp_ratio
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.dwconv(self.fc1(x))))


class MiTBlock(nn.Module):
    """Pre-norm transformer block: x + attn(norm1(x)), then
    x + mlp(norm2(x)), LayerNorms at 1e-6."""

    def __init__(self, dim: int, heads: int, sr_ratio: int,
                 mlp_ratio: int = 4):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = EfficientAttention(dim, heads, sr_ratio)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = MixFFN(dim, mlp_ratio)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class MixVisionTransformer(nn.Module):
    """The MiT encoder: four stages of overlap patch embedding (7x7
    stride 4, then 3x3 stride 2), ``depths[s]`` blocks and a stage
    LayerNorm. Takes an NCHW image batch; returns the NCHW views
    ``c1``..``c4`` (strides 4 to 32) and the head contract's aliases
    ``low`` (``c1``) and ``out`` (``c4``). ``remat`` (``TPU.REMAT``)
    recomputes each block's activations in the backward pass when
    gradients are on."""

    def __init__(self, embed_dims: Sequence[int] = (64, 128, 320, 512),
                 depths: Sequence[int] = (3, 8, 27, 3),
                 heads: Sequence[int] = (1, 2, 5, 8),
                 sr_ratios: Sequence[int] = (8, 4, 2, 1),
                 mlp_ratio: int = 4, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.channels = {f"c{s + 1}": int(d) for s, d in
                         enumerate(embed_dims)}
        self.channels.update(low=int(embed_dims[0]), out=int(embed_dims[3]))
        in_channels = 3
        for s in range(4):
            self.add_module(f"patch_embed{s + 1}", OverlapPatchEmbed(
                in_channels, embed_dims[s], 7 if s == 0 else 3,
                4 if s == 0 else 2))
            self.add_module(f"block{s + 1}", nn.ModuleList(
                MiTBlock(embed_dims[s], heads[s], sr_ratios[s], mlp_ratio)
                for _ in range(depths[s])))
            self.add_module(f"norm{s + 1}", LayerNorm(embed_dims[s],
                                                      eps=1e-6))
            in_channels = embed_dims[s]

    def forward(self, x):
        feats = {}
        for s in range(1, 5):
            x = getattr(self, f"patch_embed{s}")(x if s == 1 else _nchw(x))
            for block in getattr(self, f"block{s}"):
                x = (_remat(block, x) if self.remat
                     and torch.is_grad_enabled() else block(x))
            x = getattr(self, f"norm{s}")(x)
            feats[f"c{s}"] = _nchw(x)
        feats["low"] = feats["c1"]
        feats["out"] = feats["c4"]
        return feats

    def init_weights(self, generator: torch.Generator):
        """LeCun-normal (truncated) kernels and zero biases for the
        Linears and convs, identity LayerNorms, as the JAX trunk
        initialises."""
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                lecun_normal_(mod.weight, generator)
                if mod.bias is not None:
                    with torch.no_grad():
                        mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                with torch.no_grad():
                    mod.weight.fill_(1.0)
                    mod.bias.zero_()


# name: the JAX package's MIT_ARCHS entry (embed_dims, depths, heads)
MIT_ARCHS = {
    "mitb0": dict(embed_dims=(32, 64, 160, 256), depths=(2, 2, 2, 2)),
    "mitb1": dict(embed_dims=(64, 128, 320, 512), depths=(2, 2, 2, 2)),
    "mitb2": dict(embed_dims=(64, 128, 320, 512), depths=(3, 4, 6, 3)),
    "mitb3": dict(embed_dims=(64, 128, 320, 512), depths=(3, 4, 18, 3)),
    "mitb4": dict(embed_dims=(64, 128, 320, 512), depths=(3, 8, 27, 3)),
    "mitb5": dict(embed_dims=(64, 128, 320, 512), depths=(3, 6, 40, 3)),
    "mittiny": dict(embed_dims=(16, 32, 64, 128), depths=(1, 1, 1, 1),
                    heads=(1, 2, 4, 8)),
}


def lecun_normal_(t: torch.Tensor, generator):
    """flax's ``lecun_normal``: a normal truncated at 2 sigma with
    variance 1/fan_in (sigma scaled up for the truncation)."""
    fan_in = t[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                     generator=generator)


class _SegFormerDecoder(nn.Module):
    """The all-MLP decoder: a Linear to ``embed_dim`` on each stage map,
    bilinear (align corners) to ``c1``'s size, concatenated from ``c4``
    down to ``c1``, a bias-free 1x1 ``fuse_conv``, a live ``fuse_bn``
    (momentum 0.1, eps 1e-5) and ReLU; element-wise dropout after it."""

    def __init__(self, in_channels: Sequence[int], embed_dim: int,
                 dropout: float):
        super().__init__()
        for s, cin in enumerate(in_channels):
            self.add_module(f"linear_c{s + 1}", nn.Linear(cin, embed_dim))
        self.fuse_conv = nn.Conv2d(4 * embed_dim, embed_dim, 1, bias=False)
        self.fuse_bn = nn.BatchNorm2d(embed_dim, eps=1e-5, momentum=0.1)
        self.dropout = nn.Dropout(dropout)

    def _fuse(self, feats):
        """NCHW map of the fused decoder features."""
        hw = tuple(feats["c1"].shape[2:])
        ups = [resize_bilinear(getattr(self, f"linear_c{s}")(
            _nhwc(feats[f"c{s}"])), hw) for s in range(1, 5)]
        y = _nchw(torch.cat(ups[::-1], dim=-1))
        return torch.relu(self.fuse_bn(self.fuse_conv(y)))

    def init_weights(self, generator: torch.Generator):
        """torch-default Linear kernels with zero biases, LeCun-normal
        convs with zero biases, U(+-1/sqrt(C)) MLR parameters and an
        identity BN, as the JAX heads initialise."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                uniform_fan_in_(mod.weight, mod.in_features, generator)
            elif isinstance(mod, nn.Conv2d):
                lecun_normal_(mod.weight, generator)
            elif isinstance(mod, HyperMLR):
                channels = mod.P_MLR.shape[1]
                uniform_fan_in_(mod.P_MLR, channels, generator)
                uniform_fan_in_(mod.A_MLR, channels, generator)
                continue
            else:
                continue
            if mod.bias is not None:
                with torch.no_grad():
                    mod.bias.zero_()
        reset_norms_(self)


class SegFormerHead(_SegFormerDecoder):
    """The SegFormer decoder, then the 1x1 ``cls``. Returns channel-last
    ``(logits, fused)``, logits resized to ``size`` when given."""

    def __init__(self, num_classes: int, in_channels: Sequence[int],
                 embed_dim: int = 768, dropout: float = 0.1):
        super().__init__(in_channels, embed_dim, dropout)
        self.cls = nn.Conv2d(embed_dim, num_classes, 1)

    def forward(self, feats, size: Optional[Tuple[int, int]] = None):
        fused = self._fuse(feats)
        out = _nhwc(self.cls(self.dropout(fused)))
        if size is not None:
            out = resize_bilinear(out, size)
        return out, _nhwc(fused)


class SegFormerHyperHead(_SegFormerDecoder):
    """The SegFormer decoder, then the 1x1 ``conv_reduce`` -> expmap ->
    Poincare MLR (``conv_seg``), no HFR. Returns float32 channel-last
    ``(logits, embed)``: logits resized to ``size`` when given, the ball
    embedding at ``c1``'s resolution."""

    def __init__(self, num_classes: int, in_channels: Sequence[int],
                 reduced_channels: int = 64, curvature: float = 1.0,
                 embed_dim: int = 768, dropout: float = 0.1):
        super().__init__(in_channels, embed_dim, dropout)
        self.curvature = curvature
        self.conv_reduce = nn.Conv2d(embed_dim, reduced_channels, 1)
        self.conv_seg = HyperMLR(num_classes, reduced_channels, c=curvature)

    def forward(self, feats, size: Optional[Tuple[int, int]] = None):
        y = self.conv_reduce(self.dropout(self._fuse(feats)))
        with torch.autocast(y.device.type, enabled=False):
            embed = hyp.expmap(_nhwc(y.float()), c=self.curvature)
            out = self.conv_seg(embed)
            if size is not None:
                out = resize_bilinear(out, size)
        return out, embed


def mit_feature_extractor(name: str, remat: bool = False):
    """The MiT trunk ``name`` under ``feature_extractor.backbone``."""
    return FeatureExtractor(MixVisionTransformer(remat=remat,
                                                 **MIT_ARCHS[name]))
