"""Model registry and factory: ``Segmentor`` and ``build_segmentor``.

Port of ``halo_tpu/models/build.py:39-169``. ``MODEL.NAME`` is
``<head>_<backbone>``: the head ``deeplabv2``, ``deeplabv3plus`` or
``segformer``, crossed with ``MODEL.HYPER``, on a backbone of the
ResNet/ResNeXt family or a MiT (``mitb0``-``mitb5``, ``mittiny``). The
heads take their input widths from the trunk, as flax infers them. A
SegFormer head reads the four stage maps ``c1``..``c4`` that only a MiT
trunk gives, so it is refused on a ResNet trunk when the model is built
(the JAX package builds that pair and fails in its first forward).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..device import resolve_device
from .classifier import (ASPPv2Head, ASPPv2HyperHead, SeparableASPPHead,
                         SeparableASPPHyperHead)
from .resnet import ARCHS, resnet_feature_extractor
from .segformer import (MIT_ARCHS, SegFormerHead, SegFormerHyperHead,
                        mit_feature_extractor)

BACKBONES: Dict[str, Callable[..., nn.Module]] = {
    name: (lambda cfg, _n=name: resnet_feature_extractor(
        _n, freeze_bn=bool(cfg.MODEL.FREEZE_BN),
        dense_conv_mode=str(cfg.TPU.DENSE_CONV_MODE),
        remat=bool(cfg.TPU.REMAT)))
    for name in ARCHS}
BACKBONES.update({
    name: (lambda cfg, _n=name: mit_feature_extractor(
        _n, remat=bool(cfg.TPU.REMAT)))
    for name in MIT_ARCHS})


def _stages(ch):
    """The widths of ``c1``..``c4``, which a SegFormer head reads."""
    missing = [f"c{s}" for s in range(1, 5) if f"c{s}" not in ch]
    if missing:
        raise ValueError(
            "The segformer head reads the trunk's stage maps c1..c4; this "
            f"trunk gives only {sorted(ch)} (missing {missing}). Use a MiT "
            "backbone (mitb0..mitb5, mittiny).")
    return [ch[f"c{s}"] for s in range(1, 5)]


# head factories: (cfg, the trunk's map widths) -> head
HEADS: Dict[Tuple[str, bool], Callable[..., nn.Module]] = {
    ("deeplabv2", False): lambda cfg, ch: ASPPv2Head(
        cfg.MODEL.NUM_CLASSES, in_channels=ch["out"]),
    ("deeplabv2", True): lambda cfg, ch: ASPPv2HyperHead(
        cfg.MODEL.NUM_CLASSES, cfg.MODEL.REDUCED_CHANNELS,
        float(cfg.MODEL.CURVATURE), in_channels=ch["out"]),
    ("deeplabv3plus", False): lambda cfg, ch: SeparableASPPHead(
        cfg.MODEL.NUM_CLASSES, cfg.MODEL.REDUCED_CHANNELS,
        hfr=bool(cfg.MODEL.HFR), freeze_bn=bool(cfg.MODEL.FREEZE_BN),
        in_channels=ch["out"], low_channels=ch["low"]),
    ("deeplabv3plus", True): lambda cfg, ch: SeparableASPPHyperHead(
        cfg.MODEL.NUM_CLASSES, cfg.MODEL.REDUCED_CHANNELS,
        curvature=float(cfg.MODEL.CURVATURE), hfr=bool(cfg.MODEL.HFR),
        freeze_bn=bool(cfg.MODEL.FREEZE_BN), in_channels=ch["out"],
        low_channels=ch["low"]),
    ("segformer", False): lambda cfg, ch: SegFormerHead(
        cfg.MODEL.NUM_CLASSES, _stages(ch)),
    ("segformer", True): lambda cfg, ch: SegFormerHyperHead(
        cfg.MODEL.NUM_CLASSES, _stages(ch),
        reduced_channels=cfg.MODEL.REDUCED_CHANNELS,
        curvature=float(cfg.MODEL.CURVATURE)),
}


def build_feature_extractor(cfg) -> nn.Module:
    """The trunk of ``MODEL.NAME``."""
    _, backbone_name = cfg.MODEL.NAME.split("_", 1)
    if backbone_name not in BACKBONES:
        raise NotImplementedError(f"Unsupported backbone: {backbone_name}.")
    return BACKBONES[backbone_name](cfg)


def build_classifier(cfg, channels: Optional[Dict[str, int]] = None
                     ) -> nn.Module:
    """The head of ``MODEL.NAME`` and ``MODEL.HYPER`` for a trunk whose
    maps have the widths ``channels`` (default: a ResNet's, ``low`` 256
    and ``out`` 2048). Raises ValueError for a SegFormer head on a trunk
    without ``c1``..``c4``."""
    head_name, _ = cfg.MODEL.NAME.split("_", 1)
    key = (head_name, bool(cfg.MODEL.HYPER))
    if key not in HEADS:
        raise NotImplementedError(f"Unsupported classifier: {head_name}.")
    return HEADS[key](cfg, channels or {"low": 256, "out": 2048})


class Segmentor(nn.Module):
    """feature_extractor + classifier, named like the upstream checkpoint
    prefixes (``feature_extractor.``/``classifier.``).

    ``forward`` takes an NCHW image batch and returns the head's
    channel-last ``(logits, aux)``: logits upsampled to ``size`` when
    given; ``aux`` the ball embedding (hyperbolic heads), the decoder's
    features (Euclidean v3+ and SegFormer) or None (Euclidean v2).
    """

    def __init__(self, feature_extractor: nn.Module, classifier: nn.Module):
        super().__init__()
        self.feature_extractor = feature_extractor
        self.classifier = classifier

    def forward(self, x, size: Optional[Tuple[int, int]] = None):
        return self.classifier(self.feature_extractor(x), size=size)


def _compute_dtype(cfg) -> torch.dtype:
    name = str(getattr(cfg.TPU, "COMPUTE_DTYPE", "float32"))
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def build_segmentor(cfg, device=None,
                    generator: Optional[torch.Generator] = None) -> Segmentor:
    """Build the segmentor of ``MODEL.NAME`` and ``MODEL.HYPER`` on
    ``device`` (CUDA unless the caller passes another), in eval mode, with
    a seeded random init from ``generator`` (default: seeded with
    ``max(cfg.SEED, 0)``).

    ``model.compute_dtype`` is the autocast dtype for the trunk and the
    head's convs and Linears (``TPU.COMPUTE_DTYPE``).
    ``TPU.DENSE_CONV_MODE "pallas"`` routes a ResNet trunk's eligible
    dilated 3x3 convs to kernel C; every other mode, and every MiT, keeps
    cuDNN. ``TPU.REMAT`` recomputes the trunk's blocks in the
    backward pass. The learner calls ``.train()``. Pretrained weights are a
    separate step (``models.pretrained``; ``models.convert`` carries JAX
    weights across).
    """
    dev = resolve_device(device)
    trunk = build_feature_extractor(cfg)
    model = Segmentor(trunk, build_classifier(cfg, trunk.channels))
    if generator is None:
        generator = torch.Generator().manual_seed(max(int(cfg.SEED), 0))
    model.feature_extractor.init_weights(generator)
    model.classifier.init_weights(generator)
    model.compute_dtype = _compute_dtype(cfg)
    memory_format = (torch.channels_last if dev.type == "cuda"
                     else torch.contiguous_format)
    return model.to(device=dev, memory_format=memory_format).eval()
