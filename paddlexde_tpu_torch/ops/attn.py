"""Fused temporal-context attention block, forward (kernel K4).

Counterpart of ``paddlexde_tpu/ops/attn_pallas.py``: over ``[B, N, T, D]``,
per (batch, node)

    q, k, v = conv(mq), conv(mk), conv(vsrc)      # K-tap temporal convs
    y = conv_out(softmax(q_h k_h^T / sqrt(dh) [+ mask]) v_h)

``mq``/``mk`` arrive already mixed by the row-stochastic top-k matrix (the
mix commutes with the conv, so the model hoists it). A CUDA tensor goes to
the hand-written kernel (``csrc/attn.cu``), a CPU tensor to the plain
PyTorch version; ``impl="xla"`` picks the plain version on any device and
``impl="pallas"`` demands the kernel. The kernel is forward-only and
float32-only, without the dropout input; the backward (the TPU file's
``_bwd_kernel``), dropout and bfloat16 are still to port.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import _build

__all__ = [
    "fused_temporal_attention",
    "fused_temporal_attention_plain",
    "fused_temporal_attention_kernel",
]

_IMPLS = ("auto", "xla", "pallas")


def _dt(name: str):
    return {"bfloat16": torch.bfloat16, "float64": torch.float64}.get(name, torch.float32)


def _pad_cfg(k: int, causal: bool):
    return (k - 1, 0) if causal else ((k - 1) // 2, (k - 1) // 2)


def temporal_conv_plain(x, w, b, causal: bool, dt=torch.float32):
    """out[t] = b + sum_j xpad[t + j] @ w[j] over ``x [..., T, D]``,
    ``w [K, D_in, D_out]``."""
    k = w.shape[0]
    pad = _pad_cfg(k, causal)
    xp = F.pad(x.to(dt), (0, 0, pad[0], pad[1]))
    t = x.shape[-2]
    w = w.to(dt)
    out = sum(torch.einsum("...td,df->...tf", xp[..., j : j + t, :], w[j]) for j in range(k))
    return out + b.to(dt)


def fused_temporal_attention_plain(mq, mk, vsrc, wq, bq, wk, bk, wv, bv, wo, bo,
                                   causal_q: bool, causal_kv: bool, is_mask: bool,
                                   heads: int, dtype_name: str = "float32"):
    """Plain PyTorch version (the JAX ``_ref_impl``)."""
    dt = _dt(dtype_name)
    q = temporal_conv_plain(mq, wq, bq, causal_q, dt)
    k = temporal_conv_plain(mk, wk, bk, causal_kv, dt)
    v = temporal_conv_plain(vsrc, wv, bv, causal_kv, dt)
    b, n, t_q, d = q.shape
    t_k = k.shape[-2]
    head_dim = d // heads
    q = q.reshape(b, n, t_q, heads, head_dim)
    k = k.reshape(b, n, t_k, heads, head_dim)
    v = v.reshape(b, n, t_k, heads, head_dim)
    scores = torch.einsum("bnqhd,bnkhd->bnhqk", q, k).to(torch.promote_types(dt, torch.float32))
    scores = scores / math.sqrt(head_dim)
    if is_mask:
        scores = scores + torch.triu(
            torch.full((t_q, t_q), torch.finfo(scores.dtype).min, dtype=scores.dtype,
                       device=scores.device),
            diagonal=1,
        )
    attn = torch.softmax(scores, dim=-1).to(dt)
    x = torch.einsum("bnhqk,bnkhd->bnqhd", attn, v).reshape(b, n, t_q, d)
    return temporal_conv_plain(x, wo, bo, False, dt)


def fused_temporal_attention_kernel(mq, mk, vsrc, wq, bq, wk, bk, wv, bv, wo, bo,
                                    causal_q: bool, causal_kv: bool, is_mask: bool,
                                    heads: int):
    """The CUDA kernel (float32, no autograd)."""
    arrays = (mq, mk, vsrc, wq, bq, wk, bk, wv, bv, wo, bo)
    if not mq.is_cuda:
        raise ValueError("fused_temporal_attention_kernel needs CUDA tensors")
    if any(a.dtype != torch.float32 for a in arrays):
        raise TypeError("the attention kernel takes float32 inputs and weights")
    if torch.is_grad_enabled() and any(a.requires_grad for a in arrays):
        raise NotImplementedError(
            "the attention kernel is forward-only: its backward is not ported "
            "yet (ROADMAP.md, kernel K5); use attn_impl='xla' to train"
        )
    b, n, t_q, d = mq.shape
    t_k = mk.shape[2]
    ks = wq.shape[0]
    if mk.shape != (b, n, t_k, d) or vsrc.shape != mk.shape:
        raise ValueError(f"mk/vsrc {tuple(mk.shape)}/{tuple(vsrc.shape)} do not match mq {tuple(mq.shape)}")
    for w in (wq, wk, wv, wo):
        if w.shape != (ks, d, d):
            raise ValueError(f"conv weights must be [{ks}, {d}, {d}], got {tuple(w.shape)}")
    for bias in (bq, bk, bv, bo):
        if bias.shape != (d,):
            raise ValueError(f"conv biases must be [{d}], got {tuple(bias.shape)}")
    if is_mask and t_q != t_k:
        raise ValueError(f"the causal mask needs Tq == Tk, got {t_q} and {t_k}")
    if d % 32 or d > 1024 or d % heads or t_q > 16 or t_k > 16:
        raise ValueError(
            f"the attention kernel takes D a multiple of 32 (<= 1024) split "
            f"evenly over heads and T <= 16; got D={d}, heads={heads}, "
            f"Tq={t_q}, Tk={t_k}"
        )
    lib = _build.library("attn")
    smem = lib.pxt_attn_fwd_smem_bytes(t_q, t_k, d, heads)
    if smem > 232448:
        raise ValueError(f"D={d}, T={t_q}/{t_k} needs {smem} B of shared memory (> 227 KB)")
    arrays = [a.contiguous() for a in arrays]
    ptrs = (ctypes.c_void_p * 11)(*[a.data_ptr() for a in arrays])
    out = torch.empty_like(arrays[0])
    fn = lib.pxt_attn_fwd_f32
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
                   + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    with torch.cuda.device(mq.device):
        stream = torch.cuda.current_stream(mq.device).cuda_stream
        code = fn(ptrs, out.data_ptr(), b * n, t_q, t_k, d, heads, ks,
                  int(causal_q), int(causal_kv), int(is_mask), stream)
    _build.check(lib, code, "attn_fwd_kernel")
    _build.LAUNCHES["attn_fwd"] += 1
    return out


def fused_temporal_attention(mq, mk, vsrc, wq, bq, wk, bk, wv, bv, wo, bo,
                             causal_q: bool, causal_kv: bool, is_mask: bool,
                             heads: int, dtype_name: str = "float32",
                             impl: str = "auto"):
    """Fused conv -> MHA -> conv over ``[B, N, T, D]``; weights are the four
    convs' ``[K, D, D]`` kernels and ``[D]`` biases; ``impl`` in
    ("auto", "xla", "pallas")."""
    if impl not in _IMPLS:
        raise ValueError(f"impl={impl!r} not in {_IMPLS}")
    args = (mq, mk, vsrc, wq, bq, wk, bk, wv, bv, wo, bo, causal_q, causal_kv, is_mask, heads)
    if impl == "xla" or (impl == "auto" and not mq.is_cuda):
        return fused_temporal_attention_plain(*args, dtype_name)
    if not mq.is_cuda:
        raise ValueError("attn_impl='pallas' needs CUDA tensors (the kernel runs on the card)")
    if dtype_name != "float32":
        raise NotImplementedError(
            f"the attention kernel runs float32 only; compute_dtype={dtype_name!r} "
            "is still to port (ROADMAP.md)"
        )
    return fused_temporal_attention_kernel(*args)
