"""Forward step of the port (``make_forward`` of
``halo_tpu/engine/steps.py:36-51``); the train steps are a later slice."""

from __future__ import annotations

import torch


def make_forward(model):
    """forward(x) = classifier(feature_extractor(x), size=input size).

    ``x`` is a channel-last (B, H, W, 3) image batch on the model's device.
    Returns channel-last ``(logits, embed)``: float32 logits upsampled to
    the input size and the float32 ball embedding at feature resolution.
    The trunk and decoder run under autocast in ``model.compute_dtype``.
    """

    def forward(x, size="input"):
        size = tuple(x.shape[1:3]) if size == "input" else size
        dtype = model.compute_dtype
        with torch.autocast(x.device.type, dtype=dtype,
                            enabled=dtype != torch.float32):
            return model(x.permute(0, 3, 1, 2), size=size)

    return forward
