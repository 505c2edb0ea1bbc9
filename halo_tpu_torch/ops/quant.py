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

Every quantised layer (``int8_conv`` for any conv, ``int8_dense`` for a
dense layer, a one-tap conv over its ``(..., C)`` rows) runs two kernels:
``quantize_fused`` (kernel Q, ``csrc/int8_quant.cu``; ``quantize_nhwc`` for
one source and no prologue) quantises the float activation, read in
whatever layout it has, into int8 NHWC with the channels zero-padded to a
multiple of 16, and on the way applies the work that produced it where
the layer hands it over: a frozen BatchNorm's per-channel affine, the
ReLU, and the concatenation of up to five sources (the ASPP branches),
which is then never written; ``int8_conv_kernel`` (kernel I,
``csrc/int8_conv.cu``) convolves that with the weight ``pack_weight``
packed at calibration, reading the absmax and the weight scales by
pointer. On a CPU tensor both take their plain versions
(``quantize_fused_plain``; ``int8_conv_plain`` or, for a one-tap GEMM,
``int8_gemm_plain``: float64 products of the int8 values rounded to int32,
exact because every partial sum is an integer below 2**53 in magnitude).
On a CUDA tensor they launch or raise; nothing falls back.

``QuantLayer`` is the state and bookkeeping that ``models.layers``'
``QuantConv`` and ``QuantDense`` share: ``amax``, ``w_int8``, ``w_scale``
and the packed operand ``w_packed`` are buffers kept out of
``state_dict()`` (a quantised build's ``state_dict`` is the float build's),
and a layer's mode is ``module.training`` (float), ``calibrating`` (float,
plus the running absmax and the weight snapshot; set by ``calibrate``) or
neither (int8). ``quant_state``/``load_quant_state`` carry the state
through checkpoints, ``assert_calibrated`` guards an int8 evaluation.
"""

from __future__ import annotations

import array
import warnings
from typing import Dict, Iterable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .. import kernels

# Smallest scale: keeps 1/scale finite for an all-zero calibration or
# weight channel (whose quantised values are then 0 anyway).
_EPS = 1e-12
# The scales' factor: absmax * float32(1/127) (see the module docstring).
_INV_127 = 1.0 / 127.0

# Launches of kernel I (the int8 conv) and of kernel Q (the activation
# quantise), each counted where it launches and nowhere else; of kernel Q's,
# those that applied a producer's norm or ReLU (fused sites); copies made
# to view a dense layer's input of more than four dims as kernel Q reads it
# (none on the port's models).
launches = 0
quant_launches = 0
fused_launches = 0
layout_copies = 0

_CONV_ENTRY = "halo_int8_conv"
_QUANT_ENTRY = "halo_int8_quantize"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Most sources kernel Q concatenates in one pass (the ASPP's five branches).
_MAX_SOURCES = 5
# Kernel I reads activations and weights as TMA boxes of 16-byte rows.
_CHANNEL_ALIGN = 16
# The packed weight's output channels are padded to a multiple of 8.
_CO_ALIGN = 8
# TMA's largest traversal stride: kernel I's largest conv stride.
_MAX_STRIDE = 8


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


def _act_scale(amax):
    """The activation scale ``sx`` of an absmax."""
    return torch.clamp(amax.float(), min=_EPS) * _INV_127


def quantize_act(x, amax):
    """Symmetric per-tensor int8 of ``x`` against a calibrated absmax: the
    divide and round run in float32 whatever ``x``'s dtype. Returns
    ``(xq, sx)``; ``xq`` keeps ``x``'s shape and memory layout."""
    sx = _act_scale(amax)
    xq = torch.round(x.float() / sx).clamp_(-127, 127)
    return xq.to(torch.int8), sx


def pack_weight(wq):
    """(Co, Cin, kh, kw) int8 weight, any strides -> kernel I's operand:
    contiguous (Cop, kh*kw*Cp), K-major with the tap outer and the input
    channel inner, Cp the channels padded with zeros to a multiple of 16
    and Cop the output channels to a multiple of 8."""
    co, c = wq.shape[:2]
    w = F.pad(wq.permute(0, 2, 3, 1), (0, -c % _CHANNEL_ALIGN))
    return F.pad(w.reshape(co, -1), (0, 0, 0, -co % _CO_ALIGN)).contiguous()


def unpack_weight(packed, co, c, kh, kw):
    """``pack_weight``'s inverse: the (co, c, kh, kw) int8 weight (a view;
    ``c`` up to the padded channel count)."""
    cp = packed.shape[1] // (kh * kw)
    return packed[:co].reshape(co, kh, kw, cp)[..., :c].permute(0, 3, 1, 2)


def _out_size(n, k, s, p, d):
    return (n + 2 * p - d * (k - 1) - 1) // s + 1


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def quantize_nhwc_plain(x, amax):
    """Plain version of kernel Q with one source and no prologue:
    ``quantize_act`` of a (B, C, H, W) ``x`` (any strides) as int8 (B, H,
    W, Cp), contiguous, the channels padded with zeros to Cp, a multiple
    of 16."""
    xq, _ = quantize_act(x, amax)
    return F.pad(xq.permute(0, 2, 3, 1),
                 (0, -x.shape[1] % _CHANNEL_ALIGN)).contiguous()


def quantize_fused_plain(sources, amax, scale=None, shift=None,
                         relu=False):
    """Plain version of kernel Q: ``quantize_nhwc_plain`` of
    ``relu(cat(sources) * scale + shift)``, exactly the unfused ops:
    ``torch.cat`` along the channels (none for one source), the product
    and the sum each rounded to the sources' dtype (``scale`` and
    ``shift``, per channel, cast to it), as ``FrozenBatchNorm2d`` rounds
    them, and ``torch.relu`` (a NaN stays NaN); the affine (``scale`` and
    ``shift`` together) and the ReLU are each optional."""
    if (scale is None) != (shift is None):
        raise ValueError("quantize_fused: scale and shift go together")
    x = sources[0] if len(sources) == 1 else torch.cat(list(sources), 1)
    if scale is not None:
        shape = (1, -1, 1, 1)
        x = x * scale.to(x.dtype).view(shape) + shift.to(x.dtype).view(shape)
    if relu:
        x = torch.relu(x)
    return quantize_nhwc_plain(x, amax)


def int8_conv_plain(xq, wq, scale, stride=1, padding=0, dilation=1,
                    out_dtype=torch.float32):
    """Plain version of kernel I: the int32 sums of NCHW ``xq`` with ``wq``
    (Co, Cin, kh, kw), zero padding, as a float64 conv of the int8 values
    rounded to int32 (exact on any device), then in float32 times the
    per-channel ``scale`` (sx * w_scale), cast to ``out_dtype``. NCHW in
    and out."""
    with torch.autocast(xq.device.type, enabled=False):
        y = F.conv2d(xq.double(), wq.double(), None, _pair(stride),
                     _pair(padding), _pair(dilation))
    y = torch.round(y).to(torch.int32).float()
    return (y * scale.view(1, -1, 1, 1)).to(out_dtype)


def int8_gemm_plain(a, w, scale, out_dtype=torch.float32):
    """Plain version of kernel I on a one-tap GEMM (a 1x1 stride-1 conv, a
    dense layer): the int32 ``a @ w.T`` of int8 ``a`` (M, K) and ``w``
    (N, K) as a float64 product rounded to int32 (exact), then
    ``float32(sum) * scale`` cast to ``out_dtype``."""
    with torch.autocast(a.device.type, enabled=False):
        y = torch.round(a.double() @ w.double().t()).to(torch.int32)
    return (y.float() * scale).to(out_dtype)


# ---------------------------------------------------------------------------
# The kernels' wrappers
# ---------------------------------------------------------------------------

def _device_is_cuda(t, name: str) -> bool:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type == "cuda"


def _check_scalar(amax, x, name):
    if amax.dtype != torch.float32 or amax.numel() != 1 or \
            amax.device != x.device:
        raise ValueError(f"{name}: amax must be one float32 on {x.device}")


def quantize_nhwc(x, amax):
    """Kernel Q on one (B, C, H, W) ``x`` with no prologue: ``quantize_act``
    of ``x`` in any layout (NCHW, channels-last, a view of a dense input)
    as kernel I's operand. See ``quantize_fused``."""
    return quantize_fused((x,), amax)


def _check_vector(v, c, x, name):
    if v.dtype != x.dtype or v.device != x.device or v.dim() != 1 or \
            v.numel() != c or not v.is_contiguous():
        raise ValueError(f"{name}: scale and shift must be contiguous "
                         f"({c},) {x.dtype} on {x.device}")


def quantize_fused(sources, amax, scale=None, shift=None, relu=False):
    """Kernel Q (``csrc/int8_quant.cu``): ``quantize_act`` of ``relu(cat(
    sources) * scale + shift)`` against ``amax`` (one float32 on the
    sources' device, read by the kernel) in one pass -> int8 (B, H, W,
    Cp) contiguous, the channels padded with zeros to Cp, a multiple of
    16: kernel I's operand. ``sources``: 1 to 5 float32 or bfloat16 (B,
    C_i, H, W) tensors of one dtype in any layout (a (B, C_i, 1, 1) map
    expanded over the pixels is read in place), concatenated along the
    channels; ``scale``, ``shift``: the per-channel affine in that dtype
    (a frozen BatchNorm's), or None; ``relu``: the ReLU after it. The
    kernel rounds as the unfused ops do, so the bits are
    ``quantize_fused_plain``'s, which a CPU tensor takes."""
    x = sources[0]
    if not _device_is_cuda(x, "quantize_fused"):
        return quantize_fused_plain(sources, amax, scale, shift, relu)
    if not 1 <= len(sources) <= _MAX_SOURCES:
        raise ValueError(f"quantize_fused: {len(sources)} sources; the "
                         f"kernel reads 1 to {_MAX_SOURCES}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"quantize_fused: input dtype {x.dtype}; the "
                        "kernel reads float32 or bfloat16")
    if x.dim() != 4:
        raise ValueError(f"quantize_fused: shape {tuple(x.shape)}, want "
                         "(B, C, H, W)")
    b, c, h, w = x.shape
    # each source: its pointer, first channel, channels and strides
    desc = [x.data_ptr(), 0, c, *x.stride()]
    for src in sources[1:]:
        if src.dtype != x.dtype or src.device != x.device or \
                src.dim() != 4 or (src.shape[0], *src.shape[2:]) != (b, h, w):
            raise ValueError("quantize_fused: sources of other dtypes, "
                             "devices or (B, H, W): "
                             f"{[tuple(t.shape) for t in sources]}")
        desc += [src.data_ptr(), c, src.shape[1], *src.stride()]
        c += src.shape[1]
    _check_scalar(amax, x, "quantize_fused")
    if (scale is None) != (shift is None):
        raise ValueError("quantize_fused: scale and shift go together")
    if scale is not None:
        _check_vector(scale, c, x, "quantize_fused")
        _check_vector(shift, c, x, "quantize_fused")
    if min(b, c, h, w) <= 0 or b * h * w >= 2 ** 31 - 64:
        raise ValueError(f"quantize_fused: empty or too large input "
                         f"({b}, {c}, {h}, {w})")
    desc = array.array("q", desc)   # alive until the entry returns
    cp = c + (-c % _CHANNEL_ALIGN)
    xq = torch.empty((b, h, w, cp), dtype=torch.int8, device=x.device)
    err = getattr(kernels.load(), _QUANT_ENTRY)(
        len(sources), desc.buffer_info()[0], _DTYPES[x.dtype],
        amax.data_ptr(),
        None if scale is None else scale.data_ptr(),
        None if shift is None else shift.data_ptr(), int(bool(relu)),
        xq.data_ptr(), b, h, w, cp, _EPS, _INV_127,
        kernels.current_stream(x.device))
    kernels.check(err, _QUANT_ENTRY)
    global quant_launches, fused_launches
    quant_launches += 1
    if scale is not None or relu:
        fused_launches += 1
    return xq


def int8_conv_kernel(xq, packed, w_scale, amax, kernel_size, stride=1,
                     padding=0, dilation=1, out_dtype=torch.float32):
    """Kernel I (``csrc/int8_conv.cu``): kernel Q's int8 (B, H, W, Cp)
    ``xq``, ``pack_weight``'s (Cop, kh*kw*Cp) ``packed``, float32
    ``w_scale`` (Co,) and ``amax`` (one float32), both read by the kernel
    -> (B, Co, Ho, Wo) ``out_dtype`` (float32 or bfloat16; a channels-last
    view of NHWC), zero padding, any kernel size, dilation and a stride up
    to 8. On a CPU tensor: ``int8_conv_plain`` (``int8_gemm_plain`` for a
    one-tap GEMM) on the unpacked weight and ``sx * w_scale``."""
    kernel_size, stride, padding, dilation = (
        _pair(kernel_size), _pair(stride), _pair(padding), _pair(dilation))
    kh, kw = kernel_size
    co = w_scale.shape[0]
    if not _device_is_cuda(xq, "int8_conv_kernel"):
        b, h, w, cp = xq.shape
        scale = _act_scale(amax) * w_scale
        if kernel_size == stride == (1, 1) and padding == (0, 0):
            w_int8 = unpack_weight(packed, co, cp, 1, 1)[:, :, 0, 0]
            y = int8_gemm_plain(xq.reshape(-1, cp), w_int8, scale, out_dtype)
            return y.reshape(b, h, w, co).permute(0, 3, 1, 2)
        return int8_conv_plain(xq.permute(0, 3, 1, 2),
                               unpack_weight(packed, co, cp, kh, kw), scale,
                               stride, padding, dilation, out_dtype)
    if xq.dtype != torch.int8 or packed.dtype != torch.int8:
        raise TypeError(f"int8_conv_kernel: dtypes {xq.dtype}/"
                        f"{packed.dtype}, want int8")
    if out_dtype not in _DTYPES:
        raise TypeError(f"int8_conv_kernel: output dtype {out_dtype}; the "
                        "kernel writes float32 or bfloat16")
    if w_scale.dtype != torch.float32 or not w_scale.is_contiguous() or \
            w_scale.dim() != 1:
        raise TypeError("int8_conv_kernel: w_scale must be contiguous "
                        "float32 (Co,)")
    _check_scalar(amax, xq, "int8_conv_kernel")
    if not (packed.device == w_scale.device == xq.device):
        raise ValueError("int8_conv_kernel: operands on different devices")
    if xq.dim() != 4 or not xq.is_contiguous() or xq.shape[3] % \
            _CHANNEL_ALIGN:
        raise ValueError(f"int8_conv_kernel: input {tuple(xq.shape)}, want "
                         "contiguous (B, H, W, Cp), Cp a multiple of 16")
    b, h, w, cp = xq.shape
    cop = co + (-co % _CO_ALIGN)
    if packed.shape != (cop, kh * kw * cp) or not packed.is_contiguous():
        raise ValueError(f"int8_conv_kernel: packed weight "
                         f"{tuple(packed.shape)}, want ({cop}, "
                         f"{kh * kw * cp}) contiguous")
    ho = _out_size(h, kh, stride[0], padding[0], dilation[0])
    wo = _out_size(w, kw, stride[1], padding[1], dilation[1])
    if min(b, h, w, co, ho, wo, kh, kw) <= 0 or \
            min(stride + dilation) <= 0 or min(padding) < 0 or \
            max(stride) > _MAX_STRIDE:
        raise ValueError(f"int8_conv_kernel: empty or invalid conv: x "
                         f"{tuple(xq.shape)}, kernel {kernel_size}, stride "
                         f"{stride}, padding {padding}, dilation {dilation}")
    if b * h * w >= 2 ** 31 or b * ho * wo >= 2 ** 31:
        raise ValueError("int8_conv_kernel: tensor too large")
    if xq.data_ptr() % 16 or packed.data_ptr() % 16:
        raise ValueError("int8_conv_kernel: operands not 16-byte aligned")
    y = torch.empty((b, ho, wo, co), dtype=out_dtype, device=xq.device)
    err = getattr(kernels.load(), _CONV_ENTRY)(
        xq.data_ptr(), packed.data_ptr(), amax.data_ptr(),
        w_scale.data_ptr(), y.data_ptr(), _DTYPES[out_dtype], b, h, w, cp,
        ho, wo, co, cop, kh, kw, stride[0], stride[1], padding[0],
        padding[1], dilation[0], dilation[1], _EPS, _INV_127,
        kernels.current_stream(xq.device))
    kernels.check(err, _CONV_ENTRY)
    global launches
    launches += 1
    return y.permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# The W8A8 ops of the JAX package
# ---------------------------------------------------------------------------

def int8_conv(x, w_int8, w_scale, amax, stride=1, padding=0, dilation=1,
              out_dtype=torch.float32, packed=None):
    """W8A8 conv of NCHW ``x`` (any layout) with ``w_int8`` (Co, Cin, kh,
    kw) and ``w_scale`` (Co,), against ``amax``: kernel Q, then kernel I.
    Zero padding is exact (the quantisation is symmetric). ``packed`` is
    ``pack_weight(w_int8)`` when the caller keeps it."""
    if packed is None:
        packed = pack_weight(w_int8)
    return int8_conv_kernel(quantize_nhwc(x, amax), packed, w_scale, amax,
                            tuple(w_int8.shape[2:]), stride, padding,
                            dilation, out_dtype)


def _channels_view(x):
    """A dense input (..., C) as the (B, C, H, W) view kernel Q reads: its
    rows are the pixels, in order (a copy only past four dims)."""
    if x.dim() > 4:
        flat = x.reshape(-1, *x.shape[-3:])
        if not flat._is_view():
            global layout_copies
            layout_copies += 1
        x = flat
    return x[(None,) * (4 - x.dim())].permute(0, 3, 1, 2)


def int8_dense(x, w_int8, w_scale, amax, out_dtype=torch.float32,
               packed=None):
    """W8A8 dense layer: ``x`` (..., Cin) by ``w_int8`` (Cout, Cin), the
    ``nn.Linear`` layout -> (..., Cout) in ``out_dtype``: kernel Q, then
    kernel I as a one-tap conv over the rows. ``packed`` is
    ``pack_weight`` of ``w_int8`` as a 1x1 conv weight."""
    co = w_int8.shape[0]
    if packed is None:
        packed = pack_weight(w_int8[:, :, None, None])
    y = int8_conv_kernel(quantize_nhwc(_channels_view(x), amax), packed,
                         w_scale, amax, 1, 1, 0, 1, out_dtype)
    return y.permute(0, 2, 3, 1).reshape(*x.shape[:-1], co)


# ---------------------------------------------------------------------------
# Layer state, calibration and checkpoints
# ---------------------------------------------------------------------------

class QuantLayer:
    """Quantisation state of ``QuantConv``/``QuantDense`` (mixed into
    ``nn.Conv2d``/``nn.Linear``): buffers ``amax`` (the running activation
    absmax, a float32 scalar), ``w_int8`` and ``w_scale`` (the weight
    snapshot of the last calibration, in the parameter's layout) and
    ``w_packed`` (``w_int8`` as kernel I's operand, ``pack_weight`` of it
    as a conv weight), none of them in ``state_dict()``; ``calibrating``
    is the calibration mode."""

    calibrating = False

    def _init_quant(self):
        w = self.weight
        self.register_buffer("amax", torch.zeros((), device=w.device),
                             persistent=False)
        self.register_buffer("w_scale", torch.ones(w.shape[0],
                                                   device=w.device),
                             persistent=False)
        self.register_buffer("w_int8", None, persistent=False)
        self.register_buffer("w_packed", None, persistent=False)
        self._snapshot(torch.zeros(w.shape, dtype=torch.int8,
                                   device=w.device), self.w_scale)

    def _snapshot(self, w_int8, w_scale):
        """Take ``w_int8``/``w_scale`` as the layer's frozen weights, and
        pack ``w_int8`` for kernel I."""
        self.w_int8 = w_int8.to(self.weight.device, torch.int8)
        self.w_scale = w_scale.to(self.weight.device, torch.float32)
        w = self.w_int8
        self.w_packed = pack_weight(w.reshape(w.shape + (1,) * (4 - w.dim())))

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


def calibrate(model, batches: Iterable, reset: bool = True, forward=None,
              group=None):
    """Calibration pass: run ``forward`` (default ``model``) over
    ``batches`` in eval mode without gradients, every quantised layer in
    calibration mode (float forward; ``amax`` = running max|x|; weights
    snapshot), then restore the model's training flag. By default
    (``reset``) every ``amax`` restarts from 0, so a recalibration
    replaces the scales rather than only ever widening them. Re-run after
    any weight load. ``group``: each rank calibrates on its slices of the
    global batches (none, when each of its slices was all padding), and
    every ``amax`` is then the MAX over the ranks (one all-reduce), the
    absmax of the global batches."""
    layers = [m for _, m in quant_layers(model)]
    if not layers:
        raise ValueError("the model has no quantized layers: build it with "
                         "TPU.QUANT_EVAL True (quant=True) before "
                         "calibrating")
    batches = iter(batches)
    first = next(batches, None)
    if first is None and group is None:
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
            if first is not None:
                forward(first)
            for x in batches:
                forward(x)
    finally:
        for mod in layers:
            mod.calibrating = False
        model.train(was_training)
    if group is not None:
        amax = torch.stack([mod.amax for mod in layers])
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        with torch.no_grad():
            for mod, value in zip(layers, amax.unbind()):
                mod.amax.copy_(value)
                # a rank that ran no forward has not snapshot the weights
                mod._snapshot(*quantize_weight(mod.weight))


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
