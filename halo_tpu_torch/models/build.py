"""Model factory: ``Segmentor`` and ``build_segmentor``.

Port of ``halo_tpu/models/build.py:129-169`` for the headline recipe's
model, ``deeplabv3plus_<resnet>`` with ``MODEL.HYPER True``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..device import resolve_device
from .classifier import SeparableASPPHyperHead
from .resnet import resnet_feature_extractor


class Segmentor(nn.Module):
    """feature_extractor + classifier, named like the upstream checkpoint
    prefixes (``feature_extractor.``/``classifier.``).

    ``forward`` takes an NCHW image batch and returns channel-last
    ``(logits, embed)``: logits upsampled to ``size`` when given, the ball
    embedding at feature resolution.
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
    """Build the recipe's segmentor on ``device`` (CUDA unless the caller
    passes another), in eval mode, with a seeded random init from
    ``generator`` (default: seeded with ``max(cfg.SEED, 0)``).

    ``model.compute_dtype`` is the autocast dtype for the trunk and the
    decoder (``TPU.COMPUTE_DTYPE``). ``TPU.DENSE_CONV_MODE "pallas"`` routes
    the trunk's eligible dilated 3x3 convs to kernel C; every other mode
    keeps cuDNN. The learner calls ``.train()``. Pretrained ``.pth``
    loading is a separate step (``load_state_dict``; ``models.convert``
    carries JAX weights across).
    """
    dev = resolve_device(device)
    head_name, backbone_name = cfg.MODEL.NAME.split("_", 1)
    if head_name != "deeplabv3plus" or not bool(cfg.MODEL.HYPER):
        raise NotImplementedError(
            f"Model {cfg.MODEL.NAME!r} with MODEL.HYPER={cfg.MODEL.HYPER} is "
            "not ported yet (ROADMAP.md Queue 1 item 12); the port has "
            "deeplabv3plus_<resnet> with MODEL.HYPER True.")
    freeze_bn = bool(cfg.MODEL.FREEZE_BN)
    model = Segmentor(
        resnet_feature_extractor(
            backbone_name, freeze_bn=freeze_bn,
            dense_conv_mode=str(cfg.TPU.DENSE_CONV_MODE)),
        SeparableASPPHyperHead(
            num_classes=cfg.MODEL.NUM_CLASSES,
            reduced_channels=cfg.MODEL.REDUCED_CHANNELS,
            curvature=float(cfg.MODEL.CURVATURE), hfr=bool(cfg.MODEL.HFR),
            freeze_bn=freeze_bn))
    if generator is None:
        generator = torch.Generator().manual_seed(max(int(cfg.SEED), 0))
    model.feature_extractor.init_weights(generator)
    model.classifier.init_weights(generator)
    model.compute_dtype = _compute_dtype(cfg)
    memory_format = (torch.channels_last if dev.type == "cuda"
                     else torch.contiguous_format)
    return model.to(device=dev, memory_format=memory_format).eval()
