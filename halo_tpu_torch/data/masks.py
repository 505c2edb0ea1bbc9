"""Active-mask / indicator store (copy of ``halo_tpu/data/masks.py``).

Per-image artifacts under SAVE_DIR, byte-compatible with the JAX package
and the upstream runs:

  * ``gtMask/<split>/<stem>_gtFine_labelIds.png`` — uint8 label mask,
    255-filled until regions are acquired.
  * ``gtIndicator/train/<stem>_indicator.pth`` — {'active', 'selected'}
    bool maps (torch.save format).

Writes are atomic (tmp + rename): training loaders re-read these files.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch
from PIL import Image


def save_mask_png(mask: np.ndarray, path: str):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    Image.fromarray(np.asarray(mask, np.uint8)).save(tmp, format="PNG")
    os.replace(tmp, path)


def load_mask_png(path: str) -> np.ndarray:
    return np.asarray(Image.open(path), dtype=np.uint8)


def save_indicator(indicator: Dict[str, np.ndarray], path: str):
    """torch.save of the bool maps, as the JAX package writes ``.pth``."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v).copy())
                for k, v in indicator.items()}, tmp)
    os.replace(tmp, path)


def load_indicator(path: str) -> Dict[str, np.ndarray]:
    blob = torch.load(path, map_location="cpu", weights_only=True)
    return {k: np.asarray(v.numpy()) for k, v in blob.items()}


def init_image_mask(image_path: str, mask_path: str, indicator_path: str):
    """Create the 255-filled mask PNG + scalar indicator for one image."""
    with Image.open(image_path) as img:
        w, h = img.size
    save_mask_png(np.full((h, w), 255, np.uint8), mask_path)
    save_indicator({"active": np.zeros((1,), bool),
                    "selected": np.zeros((1,), bool)}, indicator_path)
