"""Fused temporal-context attention block: forward (kernel K4) and backward (K5).

Counterpart of ``paddlexde_tpu/ops/attn_pallas.py``: over ``[B, N, T, D]``,
per (batch, node)

    q, k, v = conv(mq), conv(mk), conv(vsrc)      # K-tap temporal convs
    y = conv_out(softmax(q_h k_h^T / sqrt(dh) [+ mask]) v_h)

``mq``/``mk`` arrive already mixed by the row-stochastic top-k matrix (the
mix commutes with the conv, so the model hoists it). A CUDA tensor goes to
the hand-written kernels under a ``torch.autograd.Function`` (forward
``csrc/attn.cu``, backward ``csrc/attn_bwd.cu``), a CPU tensor to the plain
PyTorch version under autograd; ``impl="xla"`` picks the plain version on
any device and ``impl="pallas"`` demands the kernels. float32 only, without
the dropout input; dropout and bfloat16 are still to port.
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
    "fused_temporal_attention_bwd_plain",
    "fused_temporal_attention_bwd_kernel",
    "bwd_errors",
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


def _tconv_bwd_input_plain(g, w, causal: bool):
    """d(conv)/d(input): ``dx[s] = sum_j g[s - j + pad_left] @ w[j]^T``, a
    conv with the taps reversed and transposed and the padding swapped."""
    k = w.shape[0]
    pad = _pad_cfg(k, causal)
    gp = F.pad(g, (0, 0, pad[1], pad[0]))
    t = g.shape[-2]
    return sum(torch.einsum("...tf,cf->...tc", gp[..., j : j + t, :], w[k - 1 - j])
               for j in range(k))


def _conv_weight_grads_plain(x, g, k: int, causal: bool):
    """``dW [K, D_in, D_out]`` and ``db [D_out]`` of ``out = conv(x)``."""
    pad = _pad_cfg(k, causal)
    xp = F.pad(x, (0, 0, pad[0], pad[1]))
    t = x.shape[-2]
    dw = torch.stack([torch.einsum("...tc,...tf->cf", xp[..., j : j + t, :], g)
                      for j in range(k)])
    return dw, g.reshape(-1, g.shape[-1]).sum(dim=0)


def fused_temporal_attention_bwd_plain(mq, mk, vsrc, wq, bq, wk, bk, wv, bv, wo, bo, g,
                                       causal_q: bool, causal_kv: bool, is_mask: bool,
                                       heads: int):
    """Plain PyTorch backward of :func:`fused_temporal_attention_plain` for
    the output cotangent ``g``: ``(dmq, dmk, dvsrc, dwq, dbq, dwk, dbk, dwv,
    dbv, dwo, dbo)``, written out as the TPU ``_bwd_kernel`` computes it
    (q, k, v and the softmax recomputed; float64 inputs stay float64)."""
    dt = torch.promote_types(mq.dtype, torch.float32)
    mq, mk, vsrc, wq, bq, wk, bk, wv, bv, wo, bo, g = (
        a.to(dt) for a in (mq, mk, vsrc, wq, bq, wk, bk, wv, bv, wo, bo, g))
    ks = wq.shape[0]
    q = temporal_conv_plain(mq, wq, bq, causal_q, dt)
    k = temporal_conv_plain(mk, wk, bk, causal_kv, dt)
    v = temporal_conv_plain(vsrc, wv, bv, causal_kv, dt)
    b, n, t_q, d = q.shape
    t_k = k.shape[-2]
    head_dim = d // heads
    inv = 1.0 / math.sqrt(head_dim)
    qh = q.reshape(b, n, t_q, heads, head_dim)
    kh = k.reshape(b, n, t_k, heads, head_dim)
    vh = v.reshape(b, n, t_k, heads, head_dim)
    scores = torch.einsum("bnqhd,bnkhd->bnhqk", qh, kh) * inv
    if is_mask:
        scores = scores + torch.triu(
            torch.full((t_q, t_q), torch.finfo(dt).min, dtype=dt, device=scores.device),
            diagonal=1,
        )
    p = torch.softmax(scores, dim=-1)
    x_attn = torch.einsum("bnhqk,bnkhd->bnqhd", p, vh).reshape(b, n, t_q, d)
    dwo, dbo = _conv_weight_grads_plain(x_attn, g, ks, False)
    dx_attn = _tconv_bwd_input_plain(g, wo, False).reshape(b, n, t_q, heads, head_dim)
    dp = torch.einsum("bnqhd,bnkhd->bnhqk", dx_attn, vh)
    dv = torch.einsum("bnhqk,bnqhd->bnkhd", p, dx_attn).reshape(b, n, t_k, d)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = (torch.einsum("bnhqk,bnkhd->bnqhd", ds, kh) * inv).reshape(b, n, t_q, d)
    dk = (torch.einsum("bnhqk,bnqhd->bnkhd", ds, qh) * inv).reshape(b, n, t_k, d)
    dwq, dbq = _conv_weight_grads_plain(mq, dq, ks, causal_q)
    dwk, dbk = _conv_weight_grads_plain(mk, dk, ks, causal_kv)
    dwv, dbv = _conv_weight_grads_plain(vsrc, dv, ks, causal_kv)
    return (_tconv_bwd_input_plain(dq, wq, causal_q), _tconv_bwd_input_plain(dk, wk, causal_kv),
            _tconv_bwd_input_plain(dv, wv, causal_kv), dwq, dbq, dwk, dbk, dwv, dbv, dwo, dbo)


def fused_temporal_attention_kernel(mq, mk, vsrc, wq, bq, wk, bk, wv, bv, wo, bo,
                                    causal_q: bool, causal_kv: bool, is_mask: bool,
                                    heads: int):
    """The CUDA forward kernel (float32, no autograd)."""
    arrays = (mq, mk, vsrc, wq, bq, wk, bk, wv, bv, wo, bo)
    if not mq.is_cuda:
        raise ValueError("fused_temporal_attention_kernel needs CUDA tensors")
    if any(a.dtype != torch.float32 for a in arrays):
        raise TypeError("the attention kernel takes float32 inputs and weights")
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


# D3STN's flag sets (causal_q, causal_kv, is_mask): encoder self-attention,
# decoder masked self-attention, decoder source attention
_BWD_FLAGS = ((False, False, False), (True, True, True), (True, False, False))


def _check_bwd_shape(mq, mk, wq, causal_q, causal_kv, is_mask, heads):
    d, t_q, t_k, ks = mq.shape[-1], mq.shape[-2], mk.shape[-2], wq.shape[0]
    flags = (bool(causal_q), bool(causal_kv), bool(is_mask))
    if not (t_q == t_k == 12 and ks == 3 and d in (64, 128) and heads == d // 16
            and flags in _BWD_FLAGS):
        raise ValueError(
            "the attention backward kernel takes T = 12, K = 3, head dim 16 with "
            "D = 128 (8 heads) or 64 (4 heads) and D3STN's three flag sets; got "
            f"mq {tuple(mq.shape)}, mk {tuple(mk.shape)}, K={ks}, heads={heads}, "
            f"(causal_q, causal_kv, is_mask)={flags}; attn_impl=\"xla\" trains it"
        )


def fused_temporal_attention_bwd_kernel(mq, mk, vsrc, wq, bq, wk, bk, wv, bv, wo, bo, g,
                                        causal_q: bool, causal_kv: bool, is_mask: bool,
                                        heads: int):
    """The CUDA backward kernels: the 11 gradients of
    :func:`fused_temporal_attention_plain` for the output cotangent ``g``, in
    float32. One call launches the weight-bank transpose, the row kernel, the
    split weight-gradient products and their fixed-order sum
    (``csrc/attn_bwd.cu``) and counts once."""
    arrays = (mq, mk, vsrc, wq, bq, wk, bk, wv, bv, wo, bo, g)
    if not mq.is_cuda:
        raise ValueError("fused_temporal_attention_bwd_kernel needs CUDA tensors")
    if any(a.dtype != torch.float32 for a in arrays):
        raise TypeError("the attention backward kernel takes float32 inputs, weights and g")
    _check_bwd_shape(mq, mk, wq, causal_q, causal_kv, is_mask, heads)
    b, n, t_len, d = mq.shape
    ks = wq.shape[0]
    for a in (mk, vsrc, g):
        if a.shape != mq.shape:
            raise ValueError(f"mk/vsrc/g {tuple(a.shape)} do not match mq {tuple(mq.shape)}")
    for w in (wq, wk, wv, wo):
        if w.shape != (ks, d, d):
            raise ValueError(f"conv weights must be [{ks}, {d}, {d}], got {tuple(w.shape)}")
    for bias in (bq, bk, bv, bo):
        if bias.shape != (d,):
            raise ValueError(f"conv biases must be [{d}], got {tuple(bias.shape)}")
    arrays = [a.contiguous() for a in arrays]
    bank = ks * d * d
    dw = torch.empty(4 * bank + 4 * d, dtype=torch.float32, device=mq.device)
    dacts = [torch.empty_like(arrays[i]) for i in range(3)]
    rows = b * n
    if not rows:
        dw.zero_()
    else:
        splits = max(1, min(128, -(-rows * t_len // 1024)))
        lib = _build.library("attn_bwd")
        lib.pxt_attn_bwd_scratch_floats.restype = ctypes.c_int64
        lib.pxt_attn_bwd_scratch_floats.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.c_int]
        scratch = torch.empty(lib.pxt_attn_bwd_scratch_floats(rows, splits, d),
                              dtype=torch.float32, device=mq.device)
        ptrs = (ctypes.c_void_p * 12)(*[a.data_ptr() for a in arrays])
        outs = (ctypes.c_void_p * 4)(*[a.data_ptr() for a in dacts], dw.data_ptr())
        fn = lib.pxt_attn_bwd_f32
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        with torch.cuda.device(mq.device):
            stream = torch.cuda.current_stream(mq.device).cuda_stream
            code = fn(ptrs, outs, scratch.data_ptr(), rows, splits, d, int(causal_q),
                      int(causal_kv), int(is_mask), stream)
        _build.check(lib, code, "attn_bwd kernels")
        _build.LAUNCHES["attn_bwd"] += 1
    dws = [dw[i * bank : (i + 1) * bank].view(ks, d, d) for i in range(4)]
    dbs = [dw[4 * bank + i * d : 4 * bank + (i + 1) * d] for i in range(4)]
    return (*dacts, dws[0], dbs[0], dws[1], dbs[1], dws[2], dbs[2], dws[3], dbs[3])


# the 11 gradients in three groups: inputs, conv weights, conv biases
_BWD_GROUPS = ((0, 1, 2), (3, 5, 7, 9), (4, 6, 8, 10))


def bwd_errors(got, want):
    """Normalised max-abs error of each of the 11 gradients (tensors, or
    anything ``torch.as_tensor`` takes), in float64. Each is normalised by
    the largest value of its group (input, weight or bias gradients): the
    key bias gradient is zero in exact arithmetic (a constant added to every
    key leaves the softmax unchanged), so it has no scale of its own."""
    got = [torch.as_tensor(a).double().cpu() for a in got]
    want = [torch.as_tensor(w).double().cpu() for w in want]
    errs = []
    for group in _BWD_GROUPS:
        scale = max(want[i].abs().max().item() for i in group)
        for i in group:
            if got[i].shape != want[i].shape:
                raise ValueError(f"gradient {i}: shape {tuple(got[i].shape)} != {tuple(want[i].shape)}")
            errs.append((got[i] - want[i]).abs().max().item() / scale)
    return errs


class _FusedTemporalAttention(torch.autograd.Function):
    """Forward K4, backward K5 (``_vjp_fwd``/``_vjp_bwd`` of the JAX file).
    When ``mk`` is ``mq`` autograd adds the two input gradients."""

    @staticmethod
    def forward(ctx, mq, mk, vsrc, wq, bq, wk, bk, wv, bv, wo, bo, causal_q, causal_kv,
                is_mask, heads):
        ctx.save_for_backward(mq, mk, vsrc, wq, bq, wk, bk, wv, bv, wo, bo)
        ctx.statics = (causal_q, causal_kv, is_mask, heads)
        return fused_temporal_attention_kernel(mq, mk, vsrc, wq, bq, wk, bk, wv, bv, wo, bo,
                                               causal_q, causal_kv, is_mask, heads)

    @staticmethod
    def backward(ctx, g):
        grads = fused_temporal_attention_bwd_kernel(*ctx.saved_tensors, g, *ctx.statics)
        return (*grads, None, None, None, None)


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
    if not (torch.is_grad_enabled() and any(a.requires_grad for a in args[:11])):
        return fused_temporal_attention_kernel(*args)  # serving: no autograd node
    _check_bwd_shape(mq, mk, wq, causal_q, causal_kv, is_mask, heads)
    return _FusedTemporalAttention.apply(*args)
