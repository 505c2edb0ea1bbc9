"""Config package: exports the global ``cfg`` singleton like the reference
(core/configs/__init__.py:1) while also supporting explicit Config objects."""

from .node import CfgNode
from .defaults import _C

cfg = _C


def get_default_cfg():
    """Return a fresh, mutable clone of the default config tree."""
    return _C.clone()


__all__ = ["cfg", "CfgNode", "get_default_cfg"]
