"""In-process active-mask cache (copy of ``halo_tpu/data/mask_cache.py``).

The acquisition round publishes each updated mask/indicator here before the
asynchronous file write lands, and the datasets consult it first; the files
on disk stay the durable source of truth. Keys are the artifact paths.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np

_lock = threading.Lock()
_masks: Dict[str, np.ndarray] = {}
_indicators: Dict[str, Dict[str, np.ndarray]] = {}


def put_mask(path: str, mask: np.ndarray):
    with _lock:
        _masks[path] = np.asarray(mask, np.uint8)


def get_mask(path: str) -> Optional[np.ndarray]:
    with _lock:
        return _masks.get(path)


def put_indicator(path: str, indicator: Dict[str, np.ndarray]):
    with _lock:
        _indicators[path] = {k: np.asarray(v) for k, v in indicator.items()}


def get_indicator(path: str) -> Optional[Dict[str, np.ndarray]]:
    with _lock:
        return _indicators.get(path)


def clear():
    with _lock:
        _masks.clear()
        _indicators.clear()
