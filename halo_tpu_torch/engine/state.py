"""Checkpoints of the port (port of ``halo_tpu/engine/state.py:57-162``).

A checkpoint is ``torch.save`` of ``{"state_dict", "optimizer", "step",
"extra"}``: the model's ``state_dict`` under the upstream torch names, the
optimizer's state, the step count and learner counters; an int8 build's
adds ``"quant"``, its calibration (``{layer name: {amax, w_int8,
w_scale}}``, ``ops.quant.quant_state``). The JAX package
reads ``blob["state_dict"]`` of such a file
(``halo_tpu/models/port_torch.py:load_torch_checkpoint``), so a port
checkpoint loads there too. ``restore_state`` brings a whole run back
from one: model, optimizer, the schedule's position and the step.

The calibration rides along as the JAX package's ``quant`` collection
does (``halo_tpu/engine/state.py:29-153``): a quantised build restores it
(``load_module_params`` for its module), a float build ignores it, and a
calibration whose layers no longer match the build's warns and is
dropped, which leaves the layers uncalibrated
(``ops.quant.load_quant_state``).

The readers also take the JAX package's checkpoints: ``flax.serialization``
msgpack of ``{"step", "params", "frozen", "batch_stats", "opt_state",
"quant", "extra"}``, decoded by a small msgpack reader of this module's
own (maps, arrays, strings, bin, ints, floats, nil/bools, and the ext
types that carry ndarrays and numpy scalars; bfloat16 leaves are widened
to float32, which is exact). Their parameter and ``quant`` trees go
through ``models.convert``; the two SGD groups' momentum traces become
``torch.optim.SGD``'s momentum buffers.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Optional

import numpy as np
import torch

from ..models.convert import quant_tree_to_state, variables_to_state_dict
from ..ops.quant import load_quant_state, quant_state


def save_checkpoint(model, path: str, optimizer=None, step: int = 0,
                    extra: Optional[Dict] = None):
    """Write the checkpoint atomically (temporary file, then rename)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    blob = {"state_dict": {k: v.detach().cpu()
                           for k, v in model.state_dict().items()},
            "optimizer": (optimizer.state_dict()
                          if optimizer is not None else {}),
            "step": int(step), "extra": dict(extra or {})}
    quant = quant_state(model)
    if quant:
        blob["quant"] = quant
    tmp = path + ".tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)


def load_checkpoint_blob(path: str) -> Dict:
    """The whole checkpoint, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=False)


# ---------------------------------------------------------------------------
# The JAX package's msgpack checkpoints
# ---------------------------------------------------------------------------

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


def is_jax_checkpoint(path: str) -> bool:
    """Whether ``path`` holds a msgpack map of a few keys (a JAX
    checkpoint) rather than a torch file (a zip archive, or a pickle for
    the legacy format)."""
    with open(path, "rb") as f:
        head = f.read(1)
    return bool(head) and 0x81 <= head[0] <= 0x8F   # a fixmap


def _ndarray(data: bytes) -> np.ndarray:
    """flax's ndarray payload: msgpack (shape, dtype name, C-order
    bytes); bfloat16 comes back as float32."""
    shape, name, buf = _Unpacker(data).read()
    name = name if isinstance(name, str) else name.decode()
    if name == "bfloat16":
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        arr = bits.view(np.float32)
    else:
        arr = np.frombuffer(buf, np.dtype(name)).copy()
    return arr.reshape(tuple(shape))


class _Unpacker:
    """A msgpack decoder for what ``flax.serialization.msgpack_serialize``
    writes."""

    _FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
              0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def _ext(self, code: int, data: bytes):
        if code == _EXT_NDARRAY:
            return _ndarray(data)
        if code == _EXT_NPSCALAR:
            return _ndarray(data)[()]
        raise ValueError(f"msgpack: unsupported ext type {code}")

    def read(self):
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._take(b & 0x1F).decode()
        if b in self._FIXED:
            return self._unpack(self._FIXED[b])
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            return self._take(self._unpack(">" + "BHI"[b - 0xC4]))
        if b in (0xD9, 0xDA, 0xDB):
            return self._take(self._unpack(">" + "BHI"[b - 0xD9])).decode()
        if b in (0xDC, 0xDD):
            return self._array(self._unpack(">" + "HI"[b - 0xDC]))
        if b in (0xDE, 0xDF):
            return self._map(self._unpack(">" + "HI"[b - 0xDE]))
        if b in (0xC7, 0xC8, 0xC9):
            n = self._unpack(">" + "BHI"[b - 0xC7])
            code = self._unpack(">b")
            return self._ext(code, self._take(n))
        if 0xD4 <= b <= 0xD8:
            code = self._unpack(">b")
            return self._ext(code, self._take(1 << (b - 0xD4)))
        raise ValueError(f"msgpack: unsupported type byte {b:#x}")

    def _array(self, n: int):
        return [self.read() for _ in range(n)]

    def _map(self, n: int):
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        if "__msgpack_chunked_array__" in out:   # flax's chunked leaves
            chunks = out["chunks"]
            flat = np.concatenate([chunks[str(i)]
                                   for i in range(len(chunks))])
            shape = out["shape"]
            return flat.reshape(tuple(shape[str(i)]
                                      for i in range(len(shape))))
        return out


def load_jax_checkpoint(path: str) -> Dict:
    """A JAX package checkpoint as nested dicts of numpy arrays."""
    with open(path, "rb") as f:
        return _Unpacker(f.read()).read()


def jax_state_dict(blob: Dict) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` of a JAX checkpoint's variables."""
    return variables_to_state_dict(
        {c: blob.get(c) or {} for c in ("params", "frozen", "batch_stats")})


def _merge_trace(dst: Dict, src: Dict):
    """Merge an optax trace tree into ``dst``, skipping the leaves masked
    out of its group (empty maps)."""
    for k, v in src.items():
        if not isinstance(v, dict):
            dst[k] = v
        elif v:
            _merge_trace(dst.setdefault(k, {}), v)


def jax_momentum_buffers(blob: Dict, model) -> Dict[str, torch.Tensor]:
    """The SGD momentum buffer of each of ``model``'s parameters (by
    name) from a JAX checkpoint's ``opt_state``: the two groups' optax
    ``trace`` trees (``multi_transform`` over 'fea' and 'cls'), merged.
    Empty when the run had no momentum. Raises when the layout does not
    map onto the model's parameters."""
    groups = (blob.get("opt_state") or {}).get("inner_states")
    if not isinstance(groups, dict) or set(groups) != {"fea", "cls"}:
        raise ValueError(
            "JAX checkpoint: opt_state is not the package's two-group SGD "
            "(multi_transform over 'fea' and 'cls'); its optimizer state "
            "cannot be carried into torch.optim.SGD")
    merged, n_traces = {}, 0
    for name, group in groups.items():
        parts = (group.get("inner_state") or {}).values()
        traces = [p["trace"] for p in parts
                  if isinstance(p, dict) and "trace" in p]
        if len(traces) > 1:
            raise ValueError(f"JAX checkpoint: group {name!r} has "
                             f"{len(traces)} momentum traces")
        for trace in traces:
            n_traces += 1
            _merge_trace(merged, trace)
    if not n_traces:
        return {}
    if n_traces != 2:
        raise ValueError("JAX checkpoint: only one SGD group has a "
                         "momentum trace")
    names = {n for n, p in model.named_parameters() if p.requires_grad}
    buffers = {k: v for k, v in variables_to_state_dict(
        {"params": merged}).items() if not k.endswith("num_batches_tracked")}
    if buffers.keys() != names:
        raise ValueError(
            "JAX checkpoint: the momentum traces do not map onto the "
            f"model's parameters: missing {sorted(names - buffers.keys())[:8]}"
            f", without a parameter {sorted(buffers.keys() - names)[:8]}")
    return buffers


# ---------------------------------------------------------------------------
# Readers of either format
# ---------------------------------------------------------------------------

def _read_model(path: str):
    """(state_dict, quant state) of a checkpoint file of either format;
    the quant state is empty where the file has none."""
    if is_jax_checkpoint(path):
        blob = load_jax_checkpoint(path)
        return jax_state_dict(blob), quant_tree_to_state(blob.get("quant"))
    blob = load_checkpoint_blob(path)
    if isinstance(blob, dict) and "state_dict" in blob:
        return blob["state_dict"], blob.get("quant") or {}
    return blob, {}


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of a checkpoint: a port or upstream Lightning
    file (``blob["state_dict"]``), a plain ``state_dict``, or a JAX
    package checkpoint (converted to the port's names)."""
    return _read_model(path)[0]


def _restore_jax(model, optimizer, path: str) -> Dict:
    """Model and momentum buffers from a JAX checkpoint; returns its
    ``step`` and ``extra`` as a port blob would hold them."""
    blob = load_jax_checkpoint(path)
    model.load_state_dict(jax_state_dict(blob), strict=True)
    load_quant_state(model, quant_tree_to_state(blob.get("quant")))
    buffers = jax_momentum_buffers(blob, model)
    momentum = any(g.get("momentum", 0) for g in optimizer.param_groups)
    if momentum and not buffers:
        raise ValueError(f"{path}: the run has SGD momentum but the JAX "
                         "checkpoint holds no momentum traces")
    optimizer.state.clear()
    params = dict(model.named_parameters())
    for name, value in buffers.items():
        param = params[name]
        buf = torch.empty_like(param)
        buf.copy_(value.reshape(param.shape))
        optimizer.state[param]["momentum_buffer"] = buf
    return {"step": int(np.asarray(blob["step"])),
            "extra": blob.get("extra") or {}}


def restore_state(model, optimizer, scheduler, path: str) -> Dict:
    """Full-state restore of a port or JAX checkpoint: the model's
    ``state_dict`` (strict), the optimizer's state (momentum buffers, group
    LRs) and the ``LambdaLR`` at the saved step, so its next ``step()``
    gives the LR of the step after. Returns the blob (``step``,
    ``extra``)."""
    if is_jax_checkpoint(path):
        blob = _restore_jax(model, optimizer, path)
    else:
        blob = load_checkpoint_blob(path)
        model.load_state_dict(blob["state_dict"], strict=True)
        optimizer.load_state_dict(blob["optimizer"])
        load_quant_state(model, blob.get("quant"))
    step = int(blob["step"])
    scheduler.last_epoch = step
    for group, base, factor in zip(optimizer.param_groups,
                                   scheduler.base_lrs, scheduler.lr_lambdas):
        group["lr"] = base * factor(step)
    scheduler._last_lr = [group["lr"] for group in optimizer.param_groups]
    return blob


def load_module_params(model, path: str, module: str) -> bool:
    """Load one top-level module's parameters and buffers
    (``feature_extractor`` or ``classifier``) from a checkpoint, as the
    reference filters its ``state_dict`` by prefix, from a port, upstream
    or JAX package checkpoint. Keys under the prefix must match the
    module's exactly; a checkpoint without the module leaves it as it is.
    An int8 build also takes the module's calibration from the file's
    ``quant`` state, where it has one that matches its layers. Returns
    whether the checkpoint held the module."""
    prefix = module + "."
    state_dict, quant = _read_model(path)
    found = {k[len(prefix):]: v for k, v in state_dict.items()
             if k.startswith(prefix)}
    if found:
        getattr(model, module).load_state_dict(found, strict=True)
        load_quant_state(getattr(model, module), quant, prefix)
    return bool(found)
