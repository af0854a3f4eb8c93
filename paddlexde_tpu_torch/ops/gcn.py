"""Fused spatial-attention GCN mixing: forward (kernel K2) and backward (K3).

Counterpart of ``paddlexde_tpu/ops/gcn_pallas.py``: per (batch, time) slice
``x_bt [N, D]`` of ``x [B, N, T, D]``

    y = (softmax_rows(x_bt x_bt^T / sqrt(D)) * scale2 (.) gate) @ x_bt

with ``gate [N, N]`` (alpha * adj + beta * sc in the model, so it takes a
gradient). A CUDA tensor goes to the hand-written kernels under a
``torch.autograd.Function`` (forward ``csrc/gcn.cu``, backward
``csrc/gcn_bwd.cu``), a CPU tensor to the plain PyTorch version under
autograd; ``impl="xla"`` picks the plain version on any device and
``impl="pallas"`` demands the kernels. ``dtype_name="bfloat16"`` runs the
forward in bfloat16 (``csrc/gcn_bf16.cu`` on the card) and the backward as
the TPU kernel does in bfloat16: the float32 backward on the float32 values
of x and of the bfloat16 cotangent (``csrc/gcn_bwd.cu`` on the card).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = [
    "gcn_spatial_mix",
    "gcn_spatial_mix_plain",
    "gcn_spatial_mix_kernel",
    "gcn_spatial_mix_bf16_kernel",
    "gcn_spatial_mix_bwd_plain",
    "gcn_spatial_mix_bwd_kernel",
    "gcn_spatial_mix_bwd_bf16_kernel",
]

_IMPLS = ("auto", "xla", "pallas")


def _dt(name: str):
    return {"bfloat16": torch.bfloat16, "float64": torch.float64}.get(name, torch.float32)


def gcn_spatial_mix_plain(x, gate, scale2: float = 1.0, dtype_name: str = "float32"):
    """Plain PyTorch version (the JAX ``_ref_impl`` einsum chain).

    In bfloat16 it keeps the rounding points of the TPU ``_fwd_kernel``:
    the scores from x in float32 (a bfloat16 x converts exactly) times
    1/sqrt(D), the softmax in float32 times ``scale2``, a = bf16(p) *
    bf16(gate) rounded to bfloat16, then a @ bf16(x) accumulated in float32
    and rounded to bfloat16."""
    dt = _dt(dtype_name)
    if dt == torch.bfloat16:
        xf = x.float()
        score = torch.einsum("bntd,bmtd->btnm", xf, xf) * (1.0 / math.sqrt(x.shape[-1]))
        a = (torch.softmax(score, dim=-1) * scale2).to(dt) * gate.to(dt)
        return torch.einsum("btnm,bmtd->bntd", a.float(), x.to(dt).float()).to(dt)
    score = torch.einsum("bntd,bmtd->btnm", x, x) / math.sqrt(x.shape[-1])
    score = torch.softmax(score.to(torch.promote_types(dt, torch.float32)), dim=-1) * scale2
    adj = score.to(dt) * gate.to(dt)
    return torch.einsum("btnm,bmtd->bntd", adj, x.to(dt))


def gcn_spatial_mix_bwd_plain(x, gate, g, scale2: float = 1.0):
    """Plain PyTorch backward ``(dx, dgate)`` of :func:`gcn_spatial_mix_plain`
    for the output cotangent ``g``, written out as the TPU ``_bwd_kernel``
    computes it (s and p recomputed; float64 inputs stay float64)."""
    dt = torch.promote_types(x.dtype, torch.float32)
    x, gate, g = x.to(dt), gate.to(dt), g.to(dt)
    scale1 = 1.0 / math.sqrt(x.shape[-1])
    p0 = torch.softmax(torch.einsum("bntd,bmtd->btnm", x, x) * scale1, dim=-1)
    p = p0 * scale2
    da = torch.einsum("bntd,bmtd->btnm", g, x)  # dL/da = g x^T
    dx_v = torch.einsum("btnm,bntd->bmtd", p * gate, g)  # a^T g
    dgate = (p * da).sum(dim=(0, 1))
    dp0 = gate * da * scale2
    ds = p0 * (dp0 - (dp0 * p0).sum(dim=-1, keepdim=True))
    dx_qk = (torch.einsum("btnm,bmtd->bntd", ds, x)
             + torch.einsum("btnm,bntd->bmtd", ds, x)) * scale1
    return dx_v + dx_qk, dgate


def _check_bwd_shape(x):
    d = x.shape[-1]
    if d not in (64, 128):
        raise ValueError(
            f"the GCN backward kernel takes D = 64 or 128, got x {tuple(x.shape)}; "
            "gcn_impl=\"xla\" trains it"
        )


def gcn_spatial_mix_kernel(x, gate, scale2: float = 1.0):
    """The CUDA forward kernel (float32, no autograd)."""
    if not x.is_cuda:
        raise ValueError("gcn_spatial_mix_kernel needs a CUDA tensor")
    if x.dtype != torch.float32 or gate.dtype != torch.float32:
        raise TypeError("the GCN kernel takes float32 x and gate")
    if x.dim() != 4:
        raise ValueError(f"x [B, N, T, D] expected, got {tuple(x.shape)}")
    b, n, t_len, d = x.shape
    if gate.shape != (n, n):
        raise ValueError(f"gate {tuple(gate.shape)} must be [{n}, {n}]")
    if d % 32 or d > 256:
        raise ValueError(f"the GCN kernel takes D a multiple of 32 up to 256, got {d}")
    lib = _build.library("gcn")
    smem = lib.pxt_gcn_fwd_smem_bytes(n, d)
    if smem > 232448:
        raise ValueError(f"N={n}, D={d} needs {smem} B of shared memory (> 227 KB)")
    x = x.contiguous()
    gate = gate.to(x.device).contiguous()
    y = torch.empty_like(x)
    fn = lib.pxt_gcn_fwd_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(x.data_ptr(), gate.data_ptr(), y.data_ptr(), b, n, t_len, d,
                  1.0 / math.sqrt(d), float(scale2), stream)
    _build.check(lib, code, "gcn_fwd_kernel")
    _build.LAUNCHES["gcn_fwd"] += 1
    return y


def _bwd_launch(x, gate, g, scale2):
    """Launch K3 on float32 ``x``, ``gate``, ``g`` (checked by the callers)."""
    if x.dim() != 4 or g.shape != x.shape:
        raise ValueError(f"x and g [B, N, T, D] expected, got {tuple(x.shape)} and {tuple(g.shape)}")
    b, n, t_len, d = x.shape
    if gate.shape != (n, n):
        raise ValueError(f"gate {tuple(gate.shape)} must be [{n}, {n}]")
    _check_bwd_shape(x)
    x, g = x.contiguous(), g.contiguous()
    gate = gate.to(x.device).contiguous()
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx, torch.zeros_like(gate)
    dgate = torch.empty_like(gate)
    lib = _build.library("gcn_bwd")
    lib.pxt_gcn_bwd_scratch_floats.restype = ctypes.c_int64
    lib.pxt_gcn_bwd_scratch_floats.argtypes = [ctypes.c_int] * 3
    fn = lib.pxt_gcn_bwd_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    with torch.cuda.device(x.device):
        # the scratch depends on the card's SM count (csrc/gcn_bwd.cu)
        scratch = torch.empty(lib.pxt_gcn_bwd_scratch_floats(b, n, t_len), dtype=torch.float32,
                              device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(x.data_ptr(), g.data_ptr(), gate.data_ptr(), dx.data_ptr(), dgate.data_ptr(),
                  scratch.data_ptr(), b, n, t_len, d, 1.0 / math.sqrt(d), float(scale2), stream)
    _build.check(lib, code, "gcn_bwd kernels")
    return dx, dgate


def gcn_spatial_mix_bwd_kernel(x, gate, g, scale2: float = 1.0):
    """The CUDA backward kernels: ``(dx, dgate)`` in float32 for the output
    cotangent ``g``. One call launches the row pass, the column pass and the
    fixed-order dgate reduction (``csrc/gcn_bwd.cu``) and counts once."""
    if not x.is_cuda:
        raise ValueError("gcn_spatial_mix_bwd_kernel needs CUDA tensors")
    if any(a.dtype != torch.float32 for a in (x, gate, g)):
        raise TypeError("the GCN backward kernel takes float32 x, gate and g")
    out = _bwd_launch(x, gate, g, scale2)
    _build.LAUNCHES["gcn_bwd"] += 1
    return out


def gcn_spatial_mix_bwd_bf16_kernel(x, gate, g, scale2: float = 1.0):
    """K3 in bfloat16 (``dtype_name="bfloat16"``): the TPU ``_bwd_kernel``
    takes x, g and the gate in float32 whatever their dtypes, so this is the
    float32 kernel on ``x.float()`` and ``g.float()`` (exact conversions of
    bfloat16 values). x float32 or bfloat16, gate float32, g bfloat16 (or
    float32); dx goes out in x's dtype, dgate float32. Counts under
    ``gcn_bwd_bf16``."""
    if not x.is_cuda:
        raise ValueError("gcn_spatial_mix_bwd_bf16_kernel needs CUDA tensors")
    if any(a.dtype not in (torch.float32, torch.bfloat16) for a in (x, g)) or (
            gate.dtype != torch.float32):
        raise TypeError("the bfloat16 GCN backward takes float32 or bfloat16 x and g and "
                        "float32 gate")
    dx, dgate = _bwd_launch(x.float(), gate, g.float(), scale2)
    _build.LAUNCHES["gcn_bwd_bf16"] += 1
    return dx.to(x.dtype), dgate


def gcn_spatial_mix_bf16_kernel(x, gate, scale2: float = 1.0):
    """The CUDA forward kernel in bfloat16 (no autograd): x float32 or
    bfloat16, gate float32; returns y in bfloat16 (``csrc/gcn_bf16.cu``)."""
    if not x.is_cuda:
        raise ValueError("gcn_spatial_mix_bf16_kernel needs a CUDA tensor")
    if x.dtype not in (torch.float32, torch.bfloat16) or gate.dtype != torch.float32:
        raise TypeError("the bfloat16 GCN kernel takes float32 or bfloat16 x and float32 gate")
    if x.dim() != 4:
        raise ValueError(f"x [B, N, T, D] expected, got {tuple(x.shape)}")
    b, n, t_len, d = x.shape
    if gate.shape != (n, n):
        raise ValueError(f"gate {tuple(gate.shape)} must be [{n}, {n}]")
    if d not in (64, 128):
        raise ValueError(
            f"the bfloat16 GCN kernel takes D = 64 or 128, got x {tuple(x.shape)}; "
            "gcn_impl=\"xla\" runs other widths"
        )
    x = x.contiguous()
    gate = gate.to(x.device).contiguous()
    y = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    if x.numel() == 0:
        return y
    lib = _build.library("gcn_bf16")
    fn = lib.pxt_gcn_fwd_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
                   + [ctypes.c_void_p])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(x.data_ptr(), gate.data_ptr(), y.data_ptr(), b, n, t_len, d,
                  int(x.dtype == torch.bfloat16), 1.0 / math.sqrt(d), float(scale2), stream)
    _build.check(lib, code, "gcn_bf16_fwd_kernel")
    _build.LAUNCHES["gcn_fwd_bf16"] += 1
    return y


class _GcnSpatialMix(torch.autograd.Function):
    """Forward K2, backward K3 (``_vjp_fwd``/``_vjp_bwd`` of the JAX file)."""

    @staticmethod
    def forward(ctx, x, gate, scale2):
        ctx.save_for_backward(x, gate)
        ctx.scale2 = scale2
        return gcn_spatial_mix_kernel(x, gate, scale2)

    @staticmethod
    def backward(ctx, g):
        x, gate = ctx.saved_tensors
        dx, dgate = gcn_spatial_mix_bwd_kernel(x, gate, g, ctx.scale2)
        return dx, dgate.to(gate.dtype), None


class _GcnSpatialMixBf16(torch.autograd.Function):
    """The bfloat16 GCN mix: forward K2 in bfloat16, backward K3 on the
    float32 values of x and of the bfloat16 cotangent, which is what the TPU
    ``_bwd_kernel`` computes in bfloat16; on the card the kernels
    (``kernel``), elsewhere their plain versions. dx goes out in x's dtype,
    dgate in the gate's."""

    @staticmethod
    def forward(ctx, x, gate, scale2, kernel):
        ctx.save_for_backward(x, gate)
        ctx.scale2 = scale2
        ctx.kernel = kernel
        if kernel:
            return gcn_spatial_mix_bf16_kernel(x, gate, scale2)
        return gcn_spatial_mix_plain(x, gate, scale2, "bfloat16")

    @staticmethod
    def backward(ctx, g):
        x, gate = ctx.saved_tensors
        if ctx.kernel:
            dx, dgate = gcn_spatial_mix_bwd_bf16_kernel(x, gate, g, ctx.scale2)
        else:
            dx, dgate = gcn_spatial_mix_bwd_plain(x.float(), gate.float(), g.float(), ctx.scale2)
        return dx.to(x.dtype), dgate.to(gate.dtype), None, None


def gcn_spatial_mix(x, gate, scale2: float = 1.0, dtype_name: str = "float32",
                    impl: str = "auto"):
    """``softmax(x x^T / sqrt(D)) * scale2 (.) gate @ x`` over the node axis
    of ``x [B, N, T, D]``; ``impl`` in ("auto", "xla", "pallas"). In
    bfloat16 with gradients both routes go through
    :class:`_GcnSpatialMixBf16`."""
    if impl not in _IMPLS:
        raise ValueError(f"impl={impl!r} not in {_IMPLS}")
    kernel = impl == "pallas" or (impl == "auto" and x.is_cuda)
    if kernel and not x.is_cuda:
        raise ValueError("gcn_impl='pallas' needs CUDA tensors (the kernel runs on the card)")
    if kernel and dtype_name not in ("float32", "bfloat16"):
        raise NotImplementedError(f"the GCN kernels take float32 or bfloat16, not {dtype_name!r}")
    training = torch.is_grad_enabled() and (x.requires_grad or gate.requires_grad)
    if dtype_name == "bfloat16" and training:
        if kernel:
            _check_bwd_shape(x)
        return _GcnSpatialMixBf16.apply(x, gate, float(scale2), kernel)
    if not kernel:
        return gcn_spatial_mix_plain(x, gate, scale2, dtype_name)
    if dtype_name == "bfloat16":
        return gcn_spatial_mix_bf16_kernel(x, gate, scale2)
    if not training:
        return gcn_spatial_mix_kernel(x, gate, scale2)  # no autograd node
    _check_bwd_shape(x)
    return _GcnSpatialMix.apply(x, gate, float(scale2))
