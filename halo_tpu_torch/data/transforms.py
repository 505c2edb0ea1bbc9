"""Paired image/label transforms (copy of ``halo_tpu/data/transforms.py``):
PIL + numpy on the host, channel-last float32 images out.

Labels ride along as PIL images or numpy arrays (a Cityscapes label and its
active mask as one (H, W, 2) map) and come out as uint8 numpy arrays.
Stochastic transforms draw from the ``random.Random`` they are given, so a
loader can seed each sample of each epoch on its own.
"""

from __future__ import annotations

import random
from typing import Optional, Sequence, Tuple

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


def _resize_label(label, size_hw):
    """Nearest resize of a PIL or numpy label (a multi-channel numpy label
    channel by channel)."""
    h, w = size_hw
    if isinstance(label, np.ndarray):
        if label.ndim == 2:
            return np.asarray(Image.fromarray(label).resize(
                (w, h), Image.NEAREST))
        return np.stack([np.asarray(Image.fromarray(label[..., c]).resize(
            (w, h), Image.NEAREST)) for c in range(label.shape[-1])],
            axis=-1)
    return label.resize((w, h), Image.NEAREST)


class Resize:
    """Bicubic image resize to (h, w), nearest label resize;
    ``resize_label=False`` keeps native-resolution labels (eval, active)."""

    def __init__(self, size: Tuple[int, int], resize_label=True):
        self.size = tuple(size)  # (h, w)
        self.resize_label = resize_label

    def __call__(self, image, label, rng=None):
        h, w = self.size
        image = image.resize((w, h), Image.BICUBIC)
        if self.resize_label:
            label = _resize_label(label, self.size)
        return image, label


class RandomScale:
    """Scale the (h, w) base size (the image's, or ``size``) by
    s ~ U[lo, hi]."""

    def __init__(self, scale: Sequence[float], size=None, resize_label=True):
        self.scale = tuple(scale)
        self.size = size
        self.resize_label = resize_label

    def __call__(self, image, label, rng: Optional[random.Random] = None):
        rng = rng or random
        w, h = image.size
        if self.size:
            h, w = self.size
        s = self.scale[0] + (self.scale[1] - self.scale[0]) * rng.random()
        size = (int(h * s), int(w * s))
        image = image.resize((size[1], size[0]), Image.BICUBIC)
        if self.resize_label:
            label = _resize_label(label, size)
        return image, label


class RandomCrop:
    """Random (h, w) crop, padding first where the image is smaller: the
    image with ``fill``, the label with ``label_fill`` (255, ignored). As
    the reference, a short side is padded by the whole shortfall on both
    sides."""

    def __init__(self, size: Tuple[int, int], pad_if_needed=True, fill=0,
                 label_fill=255):
        self.size = tuple(size)  # (h, w)
        self.pad_if_needed = pad_if_needed
        self.fill = fill
        self.label_fill = label_fill

    @staticmethod
    def _pad(image, label, pad_lr, pad_tb, fill, label_fill):
        left, right = pad_lr
        top, bottom = pad_tb
        if left == right == top == bottom == 0:
            return image, label
        w, h = image.size
        canvas = Image.new(image.mode, (w + left + right, h + top + bottom),
                           fill)
        canvas.paste(image, (left, top))
        if isinstance(label, np.ndarray):
            spec = [(top, bottom), (left, right)] + [(0, 0)] * (
                label.ndim - 2)
            label = np.pad(label, spec, constant_values=label_fill)
        else:
            lc = Image.new(label.mode, (w + left + right, h + top + bottom),
                           label_fill)
            lc.paste(label, (left, top))
            label = lc
        return canvas, label

    def __call__(self, image, label, rng: Optional[random.Random] = None):
        rng = rng or random
        th, tw = self.size
        if self.pad_if_needed and image.size[0] < tw:
            d = tw - image.size[0]
            image, label = self._pad(image, label, (d, d), (0, 0), self.fill,
                                     self.label_fill)
        if self.pad_if_needed and image.size[1] < th:
            d = th - image.size[1]
            image, label = self._pad(image, label, (0, 0), (d, d), self.fill,
                                     self.label_fill)
        w, h = image.size
        i = 0 if h == th else rng.randint(0, h - th)
        j = 0 if w == tw else rng.randint(0, w - tw)
        image = image.crop((j, i, j + tw, i + th))
        if isinstance(label, np.ndarray):
            label = label[i:i + th, j:j + tw]
        else:
            label = label.crop((j, i, j + tw, i + th))
        return image, label


class RandomHorizontalFlip:
    """Paired flip with probability ``p``."""

    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, image, label, rng: Optional[random.Random] = None):
        rng = rng or random
        if rng.random() < self.p:
            image = image.transpose(Image.FLIP_LEFT_RIGHT)
            if isinstance(label, np.ndarray):
                label = label[:, ::-1]
            else:
                label = label.transpose(Image.FLIP_LEFT_RIGHT)
        return image, label
