"""Kernel C: the dilated 3x3 conv of the trunk (CUDA), forward and VJP.

Counterpart of ``halo_tpu/ops/pallas_conv.py`` (``dilated_conv3x3`` :150
and its custom VJP :160-186). ``dilated_conv3x3(x, weight, d)`` is a dense
3x3 conv with stride 1, padding d and dilation d, over the NCHW tensor a
module receives and an ``nn.Conv2d`` weight ``(Co, C, 3, 3)`` of the same
dtype. On a CUDA tensor it launches ``csrc/dilated_conv.cu`` (or raises):
the input is read as its channels-last buffer (the port builds its models
``channels_last`` on CUDA, so that is a view, not a copy) and the output is
the channels-last NCHW view of the kernel's NHWC buffer. On a CPU tensor it
takes the plain version, ``dilated_conv3x3_plain``.

The backward mirrors ``_vjp_bwd``: dx is the same kernel on the cotangent
with the flipped, IO-transposed weight (for stride 1 and padding d that is
again a pad-d dilation-d conv); dk is ``wgrad_taps``, nine big-K
contractions through ``torch.mm`` (the JAX package leaves them to
XLA), rounded to the weight's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels

# Kernel launches, counted where each launches and nowhere else.
launches_fwd = 0
launches_dx = 0
# Copies made to bring an input that is not channels-last into the kernel's
# layout (a cotangent handed back contiguous, for one).
layout_copies = 0

# The alignment each instantiation asks of C and of Co (the input
# gradient's C): the f32 kernel reads 16 channels a step; the bf16 kernel
# reads 64 and its TMA boxes zero-fill a partial step, so 32 (16-byte
# aligned rows) is its rule.
_K_ALIGN = {torch.bfloat16: 32, torch.float32: 16}
_ENTRY = {torch.bfloat16: "halo_dilated_conv3x3_bf16",
          torch.float32: "halo_dilated_conv3x3_f32"}


def supports(x_shape, weight_shape, d: int, dtype) -> bool:
    """Whether the kernel takes an NCHW input of ``x_shape`` with a weight
    of ``weight_shape``, forward and input gradient: 3x3, d >= 1, bf16 or
    f32, input and output channels multiples of 32 (bf16) or 16 (f32).
    The rule is symmetric in C and Co because the input gradient is the
    same kernel with the two swapped; the C entry (``shape_ok``) holds the
    same rule. Any H and W: the kernel masks its ragged tiles."""
    if dtype not in _K_ALIGN or len(x_shape) != 4 or len(weight_shape) != 4:
        return False
    b, c, h, w = map(int, x_shape)
    co, kc, kh, kw = map(int, weight_shape)
    align = _K_ALIGN[dtype]
    return ((kh, kw) == (3, 3) and kc == c and d >= 1
            and c % align == 0 and co % align == 0
            and b * h * w * max(c, co) < 2 ** 31)


def repack(weight):
    """(Co, C, 3, 3) conv weight, any strides -> contiguous (9, C, Co),
    tap-major: the GEMM operand B of each tap (the plain version and the
    float32 kernel)."""
    co, c = weight.shape[:2]
    return weight.permute(2, 3, 1, 0).reshape(9, c, co).contiguous()


def repack_kmajor(weight):
    """(Co, C, 3, 3) conv weight, any strides -> contiguous (9, Co, C):
    each tap's operand B with the reduction dim C innermost, as the bf16
    kernel's TMA boxes and wgmma descriptors read it (entry [3i+j, o, c] =
    weight[o, c, i, j])."""
    co, c = weight.shape[:2]
    return weight.permute(2, 3, 0, 1).reshape(9, co, c).contiguous()


def _taps(x_nhwc, d: int):
    """The nine shifted (B*H*W, C) slabs of the zero-padded input."""
    b, h, w, c = x_nhwc.shape
    xp = F.pad(x_nhwc, (0, 0, d, d, d, d))
    return [xp[:, i * d:i * d + h, j * d:j * d + w, :].reshape(-1, c)
            for i in range(3) for j in range(3)]


def dilated_conv3x3_plain(x, weight, d: int):
    """Plain version, what the TPU kernel's ``_kernel`` computes: pad by d,
    nine tap products ``(B*H*W, C) @ (C, Co)`` summed in float32, cast to
    the input's dtype. NCHW in and out, any layout."""
    b, _, h, w = x.shape
    co = weight.shape[0]
    with torch.autocast(x.device.type, enabled=False):
        w9 = repack(weight).float()
        acc = None
        for tap, slab in enumerate(_taps(x.permute(0, 2, 3, 1).float(), d)):
            t = slab @ w9[tap]
            acc = t if acc is None else acc + t
    return acc.reshape(b, h, w, co).to(x.dtype).permute(0, 3, 1, 2)


def wgrad_taps(x, g, d: int):
    """Weight gradient (Co, C, 3, 3) of the conv in float32: dk[tap] =
    slab(tap)^T @ g contracted over (B, H, W), each tap one matmul with
    float32 accumulation and a float32 result
    (``halo_tpu/ops/conv_grads.py:19``); the caller rounds it."""
    c, co = x.shape[1], g.shape[1]
    gm = g.permute(0, 2, 3, 1).reshape(-1, co)
    if x.device.type == "cuda" and x.dtype != torch.float32:
        def contract(a, b):  # bf16 operands, f32 accumulator and result
            return torch.mm(a, b, out_dtype=torch.float32)
    else:
        def contract(a, b):
            return a.float() @ b.float()
    with torch.autocast(x.device.type, enabled=False):
        taps = [contract(slab.t(), gm)
                for slab in _taps(x.permute(0, 2, 3, 1), d)]
    return torch.stack(taps).reshape(3, 3, c, co).permute(3, 2, 0, 1)


def _nhwc(t):
    """The contiguous NHWC view of an NCHW tensor, copying (and counting
    the copy) only when its buffer is not channels-last."""
    global layout_copies
    v = t.permute(0, 2, 3, 1)
    if not v.is_contiguous():
        layout_copies += 1
        v = v.contiguous()
    return v


def _launch(x, weight, d: int):
    """Kernel C on CUDA tensors: NCHW x, (Co, C, 3, 3) weight -> NCHW
    (channels-last) output in x's dtype."""
    if x.dtype != weight.dtype or x.dtype not in _ENTRY:
        raise TypeError(f"dilated_conv3x3: dtypes {x.dtype}/{weight.dtype}; "
                        "the kernel takes bf16 or f32, both the same")
    if weight.device != x.device:
        raise ValueError("dilated_conv3x3: x and weight on different "
                         "devices")
    if not supports(x.shape, weight.shape, d, x.dtype):
        raise ValueError(f"dilated_conv3x3: unsupported shapes "
                         f"{tuple(x.shape)} / {tuple(weight.shape)}, d={d}")
    xh = _nhwc(x)
    w9 = repack_kmajor(weight) if x.dtype == torch.bfloat16 else \
        repack(weight)
    b, h, w, c = xh.shape
    co = weight.shape[0]
    y = torch.empty((b, h, w, co), dtype=x.dtype, device=x.device)
    if xh.data_ptr() % 16 or w9.data_ptr() % 16:
        raise ValueError("dilated_conv3x3: operands not 16-byte aligned")
    entry = _ENTRY[x.dtype]
    err = getattr(kernels.load(), entry)(
        xh.data_ptr(), w9.data_ptr(), y.data_ptr(), b, h, w, c, co, int(d),
        kernels.current_stream(x.device))
    kernels.check(err, entry)
    return y.permute(0, 3, 1, 2)


def _conv(x, weight, d: int, kind: str):
    if x.device.type == "cpu":
        return dilated_conv3x3_plain(x, weight, d)
    if x.device.type != "cuda":
        raise ValueError(f"dilated_conv3x3: unsupported device {x.device}")
    y = _launch(x, weight, d)
    global launches_fwd, launches_dx
    if kind == "fwd":
        launches_fwd += 1
    else:
        launches_dx += 1
    return y


class _DilatedConv3x3(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, d):
        ctx.save_for_backward(x, weight)  # residuals (x, k), as _vjp_fwd
        ctx.d = d
        return _conv(x, weight, d, "fwd")

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = dk = None
        if ctx.needs_input_grad[0]:
            dx = _conv(g, weight.flip(2, 3).transpose(0, 1), ctx.d, "dx")
        if ctx.needs_input_grad[1]:
            dk = wgrad_taps(x, g, ctx.d).to(weight.dtype)
        return dx, dk, None


def dilated_conv3x3(x, weight, d: int):
    """Dense 3x3 conv, stride 1, padding d, dilation d: NCHW ``x`` and a
    ``(Co, C, 3, 3)`` weight of the same dtype (bf16 or f32) -> NCHW output
    in that dtype; differentiable in both."""
    return _DilatedConv3x3.apply(x, weight, int(d))
