"""Post-training int8 (W8A8) quantisation for evaluation and the int8
acquisition sweep (port of ``halo_tpu/ops/quant.py``).

  * weights: symmetric per-output-channel int8 (``quantize_weight``),
    frozen when the layer is calibrated;
  * activations: symmetric per-tensor int8 against a calibrated running
    absmax (``quantize_act``: float32 divide, round half to even, clip to
    +-127);
  * both scales are ``absmax * float32(1/127)``: the JAX package writes
    ``absmax / 127.0``, which its compiled programs (calibration, the
    evaluation steps) compute as a product by the reciprocal (XLA rewrites
    a division by a constant so), and the port computes what they do;
  * products accumulate in int32; the result is dequantised as
    ``float32(sum) * (sx * w_scale)`` and cast to the output dtype, and a
    bias is added after, by the layer.

``int8_conv`` sends a 1x1 conv without padding, and ``int8_dense`` every
dense layer, to ``int8_gemm``: ``torch._int_mm`` (cuBLASLt's int8 GEMM) on
a CUDA tensor, with zero rows and columns added where its shape rules ask
(exact for integers). Every other conv goes to ``int8_conv_kernel``, the
hand-written kernel of ``csrc/int8_conv.cu``. On a CPU tensor both take
their plain versions (``int8_gemm_plain``, ``int8_conv_plain``): float64
products of the int8 values rounded to int32, which is exact because every
partial sum is an integer below 2**53 in magnitude. On a CUDA tensor they
launch or raise; nothing falls back.

``QuantLayer`` is the state and bookkeeping that ``models.layers``'
``QuantConv`` and ``QuantDense`` share: ``amax``, ``w_int8`` and
``w_scale`` are buffers kept out of ``state_dict()`` (a quantised build's
``state_dict`` is the float build's), and a layer's mode is
``module.training`` (float), ``calibrating`` (float, plus the running
absmax and the weight snapshot; set by ``calibrate``) or neither (int8).
``quant_state``/``load_quant_state`` carry the state through
checkpoints, ``assert_calibrated`` guards an int8 evaluation.
"""

from __future__ import annotations

import warnings
from typing import Dict, Iterable, Optional

import torch
import torch.nn.functional as F

from .. import kernels

# Smallest scale: keeps 1/scale finite for an all-zero calibration or
# weight channel (whose quantised values are then 0 anyway).
_EPS = 1e-12
# The scales' factor: absmax * float32(1/127) (see the module docstring).
_INV_127 = 1.0 / 127.0

# Launches of the int8 conv kernel, counted where it launches and nowhere
# else; ``torch._int_mm`` calls of the GEMM path on CUDA; copies made to
# bring an activation into the kernel's layout (channels-last, channels a
# multiple of 16).
launches = 0
gemm_calls = 0
layout_copies = 0

_ENTRY = "halo_int8_conv"
_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The kernel reads activations and weights 16 bytes (channels) at a time.
_CHANNEL_ALIGN = 16


def _pair(v):
    return (int(v), int(v)) if isinstance(v, int) else tuple(int(a) for a in v)


def quantize_weight(weight):
    """Symmetric per-output-channel int8 of a float weight whose FIRST axis
    is the output channel (an ``nn.Conv2d`` or ``nn.Linear`` weight).
    Returns ``(w_int8, w_scale)``, ``w_scale`` (Cout,) float32 and
    ``weight ~= w_int8 * w_scale``."""
    w = weight.detach().float()
    amax = w.abs().amax(dim=tuple(range(1, w.dim())))
    w_scale = torch.clamp(amax, min=_EPS) * _INV_127
    shape = (-1,) + (1,) * (w.dim() - 1)
    w_int8 = torch.clamp(torch.round(w / w_scale.view(shape)), -127, 127)
    return w_int8.to(torch.int8), w_scale


def quantize_act(x, amax):
    """Symmetric per-tensor int8 of ``x`` against a calibrated absmax: the
    divide and round run in float32 whatever ``x``'s dtype. Returns
    ``(xq, sx)``; ``xq`` keeps ``x``'s shape and memory layout."""
    sx = torch.clamp(amax.float(), min=_EPS) * _INV_127
    xq = torch.round(x.float() / sx).clamp_(-127, 127)
    return xq.to(torch.int8), sx


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def int8_conv_plain(xq, wq, scale, stride=1, padding=0, dilation=1,
                    out_dtype=torch.float32):
    """Plain version of the int8 conv kernel: the int32 sums of NCHW ``xq``
    with ``wq`` (Co, Cin, kh, kw), zero padding, as a float64 conv of the
    int8 values rounded to int32 (exact on any device), then in float32
    times the per-channel ``scale`` (sx * w_scale), cast to
    ``out_dtype``. NCHW in and out."""
    with torch.autocast(xq.device.type, enabled=False):
        y = F.conv2d(xq.double(), wq.double(), None, _pair(stride),
                     _pair(padding), _pair(dilation))
    y = torch.round(y).to(torch.int32).float()
    return (y * scale.view(1, -1, 1, 1)).to(out_dtype)


def int8_gemm_plain(a, w, scale, out_dtype=torch.float32):
    """Plain version of ``int8_gemm``: the int32 ``a @ w.T`` as a float64
    product rounded to int32 (exact), then as ``int8_gemm`` goes on."""
    with torch.autocast(a.device.type, enabled=False):
        y = torch.round(a.double() @ w.double().t()).to(torch.int32)
    return (y.float() * scale).to(out_dtype)


# ---------------------------------------------------------------------------
# The CUDA paths
# ---------------------------------------------------------------------------

def _device_is_cuda(t, name: str) -> bool:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type == "cuda"


def int8_gemm(a, w, scale, out_dtype=torch.float32):
    """``float32(a @ w.T) * scale`` cast to ``out_dtype``: int8 ``a``
    (M, K), int8 ``w`` (N, K), float32 ``scale`` (N,). On CUDA the int32
    product is ``torch._int_mm``; rows (to more than 16) and K and N (to
    multiples of 8) are padded with zeros where its rules ask."""
    if not _device_is_cuda(a, "int8_gemm"):
        return int8_gemm_plain(a, w, scale, out_dtype)
    if a.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8_gemm: dtypes {a.dtype}/{w.dtype}, want int8")
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[1]:
        raise ValueError(f"int8_gemm: shapes {tuple(a.shape)} / "
                         f"{tuple(w.shape)}")
    m, k = a.shape
    n = w.shape[0]
    pk, pn = -k % 8, -n % 8
    if pk or m <= 16:
        a = F.pad(a, (0, pk, 0, max(0, 17 - m)))
    if pk or pn:
        w = F.pad(w, (0, pk, 0, pn))
    global gemm_calls
    y = torch._int_mm(a.contiguous(), w.contiguous().t())
    gemm_calls += 1
    return (y[:m, :n].float() * scale).to(out_dtype)


def pack_weight(wq):
    """(Co, Cin, kh, kw) int8 weight, any strides -> the kernel's operand:
    contiguous (Co, kh*kw*Cp), K-major with the tap outer and the input
    channel inner, Cp the channels padded with zeros to a multiple of
    16."""
    co, c = wq.shape[:2]
    w = wq.permute(0, 2, 3, 1)
    pad = -c % _CHANNEL_ALIGN
    if pad:
        w = F.pad(w, (0, pad))
    return w.reshape(co, -1).contiguous()


def _out_size(n, k, s, p, d):
    return (n + 2 * p - d * (k - 1) - 1) // s + 1


def int8_conv_kernel(xq, wq, scale, stride=1, padding=0, dilation=1,
                     out_dtype=torch.float32, packed=None):
    """The int8 conv kernel (``csrc/int8_conv.cu``): NCHW int8 ``xq`` (read
    as its channels-last buffer), ``wq`` (Co, Cin, kh, kw) int8, float32
    ``scale`` (Co,) -> NCHW (channels-last) ``out_dtype`` (float32 or
    bfloat16), zero padding, any kernel size, stride and dilation.
    ``packed`` is ``pack_weight(wq)`` when the caller keeps it. On a CPU
    tensor: ``int8_conv_plain``."""
    stride, padding, dilation = _pair(stride), _pair(padding), \
        _pair(dilation)
    if not _device_is_cuda(xq, "int8_conv_kernel"):
        return int8_conv_plain(xq, wq, scale, stride, padding, dilation,
                               out_dtype)
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"int8_conv_kernel: dtypes {xq.dtype}/{wq.dtype}, "
                        "want int8")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"int8_conv_kernel: output dtype {out_dtype}; the "
                        "kernel writes float32 or bfloat16")
    if scale.dtype != torch.float32 or not scale.is_contiguous():
        raise TypeError("int8_conv_kernel: scale must be contiguous float32")
    if not (wq.device == scale.device == xq.device):
        raise ValueError("int8_conv_kernel: operands on different devices")
    if xq.dim() != 4 or wq.dim() != 4 or wq.shape[1] != xq.shape[1]:
        raise ValueError(f"int8_conv_kernel: shapes {tuple(xq.shape)} / "
                         f"{tuple(wq.shape)}")
    b, c, h, w = xq.shape
    co, _, kh, kw = wq.shape
    if scale.shape != (co,):
        raise ValueError(f"int8_conv_kernel: scale {tuple(scale.shape)}, "
                         f"want ({co},)")
    ho = _out_size(h, kh, stride[0], padding[0], dilation[0])
    wo = _out_size(w, kw, stride[1], padding[1], dilation[1])
    if min(b, c, co, ho, wo) <= 0 or min(stride + dilation) <= 0 or min(
            padding) < 0:
        raise ValueError(f"int8_conv_kernel: empty or invalid conv: x "
                         f"{tuple(xq.shape)}, w {tuple(wq.shape)}, stride "
                         f"{stride}, padding {padding}, dilation {dilation}")
    cp = c + (-c % _CHANNEL_ALIGN)
    if b * h * w * cp >= 2 ** 40 or b * ho * wo >= 2 ** 31:
        raise ValueError("int8_conv_kernel: tensor too large")
    xh = xq.permute(0, 2, 3, 1)
    if cp != c or not xh.is_contiguous():
        global layout_copies
        layout_copies += 1
        xh = F.pad(xh, (0, cp - c)).contiguous()
    if packed is None:
        packed = pack_weight(wq)
    if packed.shape != (co, kh * kw * cp) or not packed.is_contiguous():
        raise ValueError(f"int8_conv_kernel: packed weight "
                         f"{tuple(packed.shape)}, want ({co}, "
                         f"{kh * kw * cp}) contiguous")
    if xh.data_ptr() % 16 or packed.data_ptr() % 16:
        raise ValueError("int8_conv_kernel: operands not 16-byte aligned")
    y = torch.empty((b, ho, wo, co), dtype=out_dtype, device=xq.device)
    err = getattr(kernels.load(), _ENTRY)(
        xh.data_ptr(), packed.data_ptr(), scale.data_ptr(), y.data_ptr(),
        _OUT_DTYPES[out_dtype], b, h, w, cp, ho, wo, co, kh, kw,
        stride[0], stride[1], padding[0], padding[1], dilation[0],
        dilation[1], kernels.current_stream(xq.device))
    kernels.check(err, _ENTRY)
    global launches
    launches += 1
    return y.permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# The W8A8 ops of the JAX package
# ---------------------------------------------------------------------------

def int8_conv(x, w_int8, w_scale, amax, stride=1, padding=0, dilation=1,
              out_dtype=torch.float32, packed=None):
    """W8A8 conv of NCHW ``x`` with ``w_int8`` (Co, Cin, kh, kw) and
    ``w_scale`` (Co,), against ``amax``: quantise ``x``, int32 sums,
    dequantise to ``out_dtype``. Zero padding is exact (the quantisation is
    symmetric). A 1x1 conv without padding is a channel GEMM
    (``int8_gemm``; a strided one first takes every ``stride``-th pixel);
    every other conv runs the kernel (``int8_conv_kernel``)."""
    stride, padding, dilation = _pair(stride), _pair(padding), \
        _pair(dilation)
    xq, sx = quantize_act(x, amax)
    scale = sx * w_scale
    co, c, kh, kw = w_int8.shape
    if (kh, kw) == (1, 1) and padding == (0, 0):
        if stride != (1, 1):
            xq = xq[:, :, ::stride[0], ::stride[1]]
        b, _, h, w = xq.shape
        a = xq.permute(0, 2, 3, 1).reshape(-1, c)
        y = int8_gemm(a, w_int8.reshape(co, c), scale, out_dtype)
        return y.reshape(b, h, w, co).permute(0, 3, 1, 2)
    return int8_conv_kernel(xq, w_int8, scale, stride, padding, dilation,
                            out_dtype, packed)


def int8_dense(x, w_int8, w_scale, amax, out_dtype=torch.float32):
    """W8A8 dense layer: ``x`` (..., Cin) by ``w_int8`` (Cout, Cin), the
    ``nn.Linear`` layout -> (..., Cout) in ``out_dtype``."""
    xq, sx = quantize_act(x, amax)
    y = int8_gemm(xq.reshape(-1, xq.shape[-1]), w_int8, sx * w_scale,
                  out_dtype)
    return y.reshape(*x.shape[:-1], w_int8.shape[0])


# ---------------------------------------------------------------------------
# Layer state, calibration and checkpoints
# ---------------------------------------------------------------------------

class QuantLayer:
    """Quantisation state of ``QuantConv``/``QuantDense`` (mixed into
    ``nn.Conv2d``/``nn.Linear``): buffers ``amax`` (the running activation
    absmax, a float32 scalar), ``w_int8`` and ``w_scale`` (the weight
    snapshot of the last calibration, in the parameter's layout), none of
    them in ``state_dict()``; ``calibrating`` is the calibration mode."""

    calibrating = False

    def _init_quant(self):
        w = self.weight
        self.register_buffer("amax", torch.zeros((), device=w.device),
                             persistent=False)
        self.register_buffer("w_int8", torch.zeros(
            w.shape, dtype=torch.int8, device=w.device), persistent=False)
        self.register_buffer("w_scale", torch.ones(w.shape[0],
                                                   device=w.device),
                             persistent=False)

    def _snapshot(self, w_int8, w_scale):
        """Take ``w_int8``/``w_scale`` as the layer's frozen weights."""
        self.w_int8 = w_int8.to(self.weight.device, torch.int8)
        self.w_scale = w_scale.to(self.weight.device, torch.float32)

    @torch.no_grad()
    def observe(self, x):
        """Calibration: fold max|x| into ``amax`` and snapshot the
        weights."""
        self.amax.copy_(torch.maximum(self.amax,
                                      x.detach().abs().max().float()))
        self._snapshot(*quantize_weight(self.weight))

    def out_dtype(self, x):
        """The autocast dtype when autocast is on, else ``x``'s dtype."""
        kind = x.device.type
        return (torch.get_autocast_dtype(kind)
                if torch.is_autocast_enabled(kind) else x.dtype)


def quant_layers(model):
    """[(name, layer)] of ``model``'s quantised layers, in module order."""
    return [(name, mod) for name, mod in model.named_modules()
            if isinstance(mod, QuantLayer)]


def calibrate(model, batches: Iterable, reset: bool = True, forward=None):
    """Calibration pass: run ``forward`` (default ``model``) over
    ``batches`` in eval mode without gradients, every quantised layer in
    calibration mode (float forward; ``amax`` = running max|x|; weights
    snapshot), then restore the model's training flag. By default
    (``reset``) every ``amax`` restarts from 0, so a recalibration
    replaces the scales rather than only ever widening them. Re-run after
    any weight load."""
    layers = [m for _, m in quant_layers(model)]
    if not layers:
        raise ValueError("the model has no quantized layers: build it with "
                         "TPU.QUANT_EVAL True (quant=True) before "
                         "calibrating")
    batches = iter(batches)
    first = next(batches, None)
    if first is None:
        raise ValueError("calibrate() needs at least one batch")
    forward = forward or model
    if reset:
        for mod in layers:
            mod.amax.zero_()
    was_training = model.training
    model.eval()
    for mod in layers:
        mod.calibrating = True
    try:
        with torch.no_grad():
            forward(first)
            for x in batches:
                forward(x)
    finally:
        for mod in layers:
            mod.calibrating = False
        model.train(was_training)


def assert_calibrated(model):
    """Raise ValueError unless ``model`` has quantised layers and every one
    has seen calibration data (``amax`` > 0)."""
    layers = quant_layers(model)
    if not layers:
        raise ValueError("the model has no quantized layers: build it with "
                         "TPU.QUANT_EVAL True and run ops.quant.calibrate")
    amax = torch.stack([m.amax.float() for _, m in layers]).cpu()
    for (name, _), value in zip(layers, amax.tolist()):
        if not value > 0.0:
            raise ValueError(f"uncalibrated quantized layer at {name}: run "
                             "ops.quant.calibrate on representative "
                             "batches first")


_STATE_KEYS = ("amax", "w_int8", "w_scale")


def quant_state(model) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{layer name: {'amax', 'w_int8', 'w_scale'}}`` of ``model``'s
    quantised layers, on the CPU (empty for a float model)."""
    return {name: {k: getattr(mod, k).detach().cpu() for k in _STATE_KEYS}
            for name, mod in quant_layers(model)}


def load_quant_state(model, state: Optional[Dict], prefix: str = ""
                     ) -> bool:
    """Load the entries of ``state`` under ``prefix`` into ``model``'s
    quantised layers; returns whether it did. A float model, or no entry
    under ``prefix``, leaves the model as it is. When the entries' layers
    or shapes differ from the model's (the eligibility rule changed since
    the checkpoint was calibrated), warn and keep the model's own state,
    so that ``assert_calibrated`` sends it to recalibration."""
    layers = dict(quant_layers(model))
    found = {k[len(prefix):]: v for k, v in (state or {}).items()
             if k.startswith(prefix)}
    if not layers or not found:
        return False
    missing = sorted(set(layers) - set(found))
    extra = sorted(set(found) - set(layers))
    bad = [n for n in set(layers) & set(found)
           if set(found[n]) != set(_STATE_KEYS)
           or tuple(found[n]["w_int8"].shape) != tuple(
               layers[n].w_int8.shape)
           or tuple(found[n]["w_scale"].shape) != tuple(
               layers[n].w_scale.shape)]
    if missing or extra or bad:
        warnings.warn(
            "checkpoint quant state does not match this build's quantized "
            "layer set (eligibility drift?): ignoring it; missing "
            f"{missing[:4]}, unexpected {extra[:4]}, other shapes "
            f"{sorted(bad)[:4]}")
        return False
    for name, mod in layers.items():
        entry = found[name]
        with torch.no_grad():
            mod.amax.copy_(torch.as_tensor(entry["amax"]).float().reshape(()))
        mod._snapshot(torch.as_tensor(entry["w_int8"]),
                      torch.as_tensor(entry["w_scale"]))
    return True
