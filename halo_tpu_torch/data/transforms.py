"""Paired image/label transforms of the acquisition sweep (copy of the
eval-path transforms of ``halo_tpu/data/transforms.py``): PIL + numpy on
the host, channel-last float32 images out."""

from __future__ import annotations

from typing import Tuple

import numpy as np
from PIL import Image


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, image, label, rng=None):
        for t in self.transforms:
            image, label = t(image, label, rng)
        return image, label


class ToArray:
    """PIL image -> (H, W, 3) float32 in [0, 1]; the label passes as a
    numpy array of its own dtype."""

    def __call__(self, image, label, rng=None):
        return np.asarray(image, dtype=np.float32) / 255.0, np.asarray(label)


class Normalize:
    """Per-channel (x - mean) / std with the optional BGR*255 path."""

    def __init__(self, mean, std, to_bgr255=False):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.to_bgr255 = to_bgr255

    def __call__(self, image, label, rng=None):
        if self.to_bgr255:
            image = image[..., ::-1] * 255.0
        return (image - self.mean) / self.std, label


class Resize:
    """Bicubic image resize to (h, w). Only ``resize_label=False`` (keep
    native-resolution labels, the eval/active path) is ported."""

    def __init__(self, size: Tuple[int, int], resize_label=False):
        if resize_label:
            raise NotImplementedError(
                "label resizing (the train transforms) is not ported yet "
                "(ROADMAP.md Queue 1 item 5)")
        self.size = tuple(size)  # (h, w)

    def __call__(self, image, label, rng=None):
        h, w = self.size
        return image.resize((w, h), Image.BICUBIC), label
