"""Fused spatial-attention GCN mixing, forward (kernel K2).

Counterpart of ``paddlexde_tpu/ops/gcn_pallas.py``: per (batch, time) slice
``x_bt [N, D]`` of ``x [B, N, T, D]``

    y = (softmax_rows(x_bt x_bt^T / sqrt(D)) * scale2 (.) gate) @ x_bt

with a static ``gate [N, N]``. A CUDA tensor goes to the hand-written kernel
(``csrc/gcn.cu``), a CPU tensor to the plain PyTorch version; ``impl="xla"``
picks the plain version on any device and ``impl="pallas"`` demands the
kernel. The kernel is forward-only and float32-only in this version; its
backward (the TPU file's ``_bwd_kernel``) and bfloat16 are still to port.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["gcn_spatial_mix", "gcn_spatial_mix_plain", "gcn_spatial_mix_kernel"]

_IMPLS = ("auto", "xla", "pallas")


def _dt(name: str):
    return {"bfloat16": torch.bfloat16, "float64": torch.float64}.get(name, torch.float32)


def gcn_spatial_mix_plain(x, gate, scale2: float = 1.0, dtype_name: str = "float32"):
    """Plain PyTorch version (the JAX ``_ref_impl`` einsum chain)."""
    dt = _dt(dtype_name)
    score = torch.einsum("bntd,bmtd->btnm", x, x) / math.sqrt(x.shape[-1])
    score = torch.softmax(score.to(torch.promote_types(dt, torch.float32)), dim=-1) * scale2
    adj = score.to(dt) * gate.to(dt)
    return torch.einsum("btnm,bmtd->bntd", adj, x.to(dt))


def gcn_spatial_mix_kernel(x, gate, scale2: float = 1.0):
    """The CUDA kernel (float32, no autograd)."""
    if not x.is_cuda:
        raise ValueError("gcn_spatial_mix_kernel needs a CUDA tensor")
    if x.dtype != torch.float32 or gate.dtype != torch.float32:
        raise TypeError("the GCN kernel takes float32 x and gate")
    if torch.is_grad_enabled() and (x.requires_grad or gate.requires_grad):
        raise NotImplementedError(
            "the GCN kernel is forward-only: its backward is not ported yet "
            "(ROADMAP.md, kernel K3); use gcn_impl='xla' to train"
        )
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


def gcn_spatial_mix(x, gate, scale2: float = 1.0, dtype_name: str = "float32",
                    impl: str = "auto"):
    """``softmax(x x^T / sqrt(D)) * scale2 (.) gate @ x`` over the node axis
    of ``x [B, N, T, D]``; ``impl`` in ("auto", "xla", "pallas")."""
    if impl not in _IMPLS:
        raise ValueError(f"impl={impl!r} not in {_IMPLS}")
    if impl == "xla" or (impl == "auto" and not x.is_cuda):
        return gcn_spatial_mix_plain(x, gate, scale2, dtype_name)
    if not x.is_cuda:
        raise ValueError("gcn_impl='pallas' needs CUDA tensors (the kernel runs on the card)")
    if dtype_name != "float32":
        raise NotImplementedError(
            f"the GCN kernel runs float32 only; compute_dtype={dtype_name!r} "
            "is still to port (ROADMAP.md)"
        )
    return gcn_spatial_mix_kernel(x, gate, scale2)
