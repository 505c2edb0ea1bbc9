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
again a pad-d dilation-d conv; ``repack_flipped`` builds its operand in
one copy); dk, nine big-K contractions in float32 rounded once to the
weight's dtype, is ``csrc/dilated_conv_wgrad.cu`` for a CUDA bf16 tensor
and ``wgrad_taps`` (``torch.mm``, its plain version) otherwise: in float32
on the card it already beats cuDNN's wgrad. The cotangent's channels-last
view is made once for both.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels

# Kernel launches, counted where each launches and nowhere else.
launches_fwd = 0
launches_dx = 0
launches_dk = 0
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


_REVERSED_TAPS = {}


def repack_flipped(weight, kmajor: bool):
    """The dx conv's operand in one copy: ``repack_kmajor(w)`` (bf16
    kernel) or ``repack(w)`` (f32 kernel) of the flipped, IO-transposed
    ``w = weight.flip(2, 3).transpose(0, 1)``, bit for bit. Flipping both
    spatial axes reverses the tap order 3i+j -> 8-(3i+j), so this is the
    plain repack of ``weight`` with the taps read backwards: entry
    [t, c, o] (kmajor) or [t, o, c] is weight[o, c, (8-t)//3, (8-t)%3]."""
    co, c = weight.shape[:2]
    if kmajor:
        taps = weight.permute(2, 3, 1, 0).reshape(9, c, co)
    else:
        taps = weight.permute(2, 3, 0, 1).reshape(9, co, c)
    rev = _REVERSED_TAPS.get(weight.device)
    if rev is None:
        rev = torch.arange(8, -1, -1, device=weight.device)
        _REVERSED_TAPS[weight.device] = rev
    return torch.index_select(taps, 0, rev)


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


def _check(x, weight, d: int):
    """Raise on what kernel C does not take: NCHW x, (Co, C, 3, 3) weight,
    the same dtype (bf16 or f32) and device, shapes under ``supports``."""
    if x.dtype != weight.dtype or x.dtype not in _ENTRY:
        raise TypeError(f"dilated_conv3x3: dtypes {x.dtype}/{weight.dtype}; "
                        "the kernel takes bf16 or f32, both the same")
    if weight.device != x.device:
        raise ValueError("dilated_conv3x3: x and weight on different "
                         "devices")
    if not supports(x.shape, weight.shape, d, x.dtype):
        raise ValueError(f"dilated_conv3x3: unsupported shapes "
                         f"{tuple(x.shape)} / {tuple(weight.shape)}, d={d}")


def _launch(xh, w9, co: int, d: int):
    """Kernel C on a CUDA NHWC input and its weight operand (f32:
    ``repack`` or ``repack_flipped``; bf16: ``repack_kmajor`` or
    ``repack_flipped``) -> NCHW (channels-last) output in the input's
    dtype."""
    b, h, w, c = xh.shape
    y = torch.empty((b, h, w, co), dtype=xh.dtype, device=xh.device)
    if xh.data_ptr() % 16 or w9.data_ptr() % 16:
        raise ValueError("dilated_conv3x3: operands not 16-byte aligned")
    entry = _ENTRY[xh.dtype]
    err = getattr(kernels.load(), entry)(
        xh.data_ptr(), w9.data_ptr(), y.data_ptr(), b, h, w, c, co, int(d),
        kernels.current_stream(xh.device))
    kernels.check(err, entry)
    return y.permute(0, 3, 1, 2)


_WORKSPACE_BYTES = {}  # (B, H, W, C, Co, d, device) -> the entry's count


def _wgrad(xh, gh, d: int):
    """dk by the weight-gradient kernel on CUDA bf16 NHWC x and cotangent
    -> (Co, C, 3, 3) bf16, through a float32 workspace it sizes."""
    b, h, w, c = xh.shape
    co = gh.shape[3]
    lib = kernels.load()
    entry = "halo_dilated_conv3x3_wgrad_bf16"
    key = (b, h, w, c, co, int(d), xh.device)
    nbytes = _WORKSPACE_BYTES.get(key)
    if nbytes is None:
        nbytes = lib.halo_dilated_conv3x3_wgrad_workspace(b, h, w, c, co,
                                                          int(d))
        _WORKSPACE_BYTES[key] = nbytes
    if nbytes < 0:
        raise ValueError(f"dilated_conv3x3: the weight-gradient kernel "
                         f"refuses x {tuple(xh.shape)}, g {tuple(gh.shape)}")
    if xh.data_ptr() % 16 or gh.data_ptr() % 16:
        raise ValueError("dilated_conv3x3: operands not 16-byte aligned")
    ws = torch.empty(nbytes, dtype=torch.uint8, device=xh.device)
    dk = torch.empty((co, c, 3, 3), dtype=xh.dtype, device=xh.device)
    err = getattr(lib, entry)(
        xh.data_ptr(), gh.data_ptr(), dk.data_ptr(), ws.data_ptr(), nbytes,
        b, h, w, c, co, int(d), kernels.current_stream(xh.device))
    kernels.check(err, entry)
    global launches_dk
    launches_dk += 1
    return dk


def _cuda_or_cpu(x) -> bool:
    """True on a CUDA tensor, False on a CPU one (the plain versions)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"dilated_conv3x3: unsupported device {x.device}")
    return x.device.type == "cuda"


def _conv(x, weight, d: int):
    """The forward: kernel C on CUDA, the plain version on the CPU."""
    if not _cuda_or_cpu(x):
        return dilated_conv3x3_plain(x, weight, d)
    _check(x, weight, d)
    w9 = repack_kmajor(weight) if x.dtype == torch.bfloat16 else \
        repack(weight)
    y = _launch(_nhwc(x), w9, weight.shape[0], d)
    global launches_fwd
    launches_fwd += 1
    return y


class _DilatedConv3x3(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, d):
        ctx.save_for_backward(x, weight)  # residuals (x, k), as _vjp_fwd
        ctx.d = d
        return _conv(x, weight, d)

    @staticmethod
    def backward(ctx, g):
        global launches_dx
        x, weight = ctx.saved_tensors
        d = ctx.d
        g = g.to(x.dtype)
        want_dx, want_dk = ctx.needs_input_grad[:2]
        dx = dk = None
        if not _cuda_or_cpu(x):
            if want_dx:
                dx = dilated_conv3x3_plain(
                    g, weight.flip(2, 3).transpose(0, 1), d)
            if want_dk:
                dk = wgrad_taps(x, g, d).to(weight.dtype)
            return dx, dk, None
        _check(x, weight, d)
        gh = _nhwc(g)  # one channels-last cotangent for dx and dk
        bf16 = x.dtype == torch.bfloat16
        if want_dx:
            dx = _launch(gh, repack_flipped(weight, kmajor=bf16),
                         weight.shape[1], d)
            launches_dx += 1
        if want_dk:
            if bf16:
                dk = _wgrad(_nhwc(x), gh, d)
            else:
                dk = wgrad_taps(x, gh.permute(0, 3, 1, 2), d)
        return dx, dk, None


def dilated_conv3x3(x, weight, d: int):
    """Dense 3x3 conv, stride 1, padding d, dilation d: NCHW ``x`` and a
    ``(Co, C, 3, 3)`` weight of the same dtype (bf16 or f32) -> NCHW output
    in that dtype; differentiable in both."""
    return _DilatedConv3x3.apply(x, weight, int(d))
