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
any device and ``impl="pallas"`` demands the kernels. ``dtype_name=
"bfloat16"`` runs the block in bfloat16 (on the card forward
``csrc/attn_bf16.cu``, backward ``csrc/attn_bwd_bf16.cu``); with gradients
both routes take the rounding points of the TPU ``_bwd_kernel``
(:func:`_bwd_plain_bf16`). :func:`fused_temporal_attention_dropout` is the
block with the softmax weights multiplied by a pre-scaled keep mask (the
dropout form of both TPU kernels); on the card the dropout forms of the same
four kernels.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import _build

__all__ = [
    "fused_temporal_attention",
    "fused_temporal_attention_dropout",
    "fused_temporal_attention_plain",
    "fused_temporal_attention_kernel",
    "fused_temporal_attention_bf16_kernel",
    "fused_temporal_attention_bwd_plain",
    "fused_temporal_attention_bwd_kernel",
    "fused_temporal_attention_bwd_bf16_kernel",
    "bwd_errors",
    "bf16_dw_splits",
    "bf16_conv_ctas",
    "f32_fwd_route",
]

_IMPLS = ("auto", "xla", "pallas")


def _dt(name: str):
    return {"bfloat16": torch.bfloat16, "float64": torch.float64}.get(name, torch.float32)


def _pad_cfg(k: int, causal: bool):
    return (k - 1, 0) if causal else ((k - 1) // 2, (k - 1) // 2)


def temporal_conv_plain(x, w, b, causal: bool, dt=torch.float32):
    """out[t] = b + sum_j xpad[t + j] @ w[j] over ``x [..., T, D]``,
    ``w [K, D_in, D_out]``. In bfloat16 (the TPU ``_tconv_tile``) each tap
    multiplies bf16(x) by bf16(w[j]) with a float32 sum, the taps add in
    float32, the sum rounds once to bfloat16 and bf16(b) adds in bfloat16."""
    k = w.shape[0]
    pad = _pad_cfg(k, causal)
    if dt == torch.bfloat16:
        xp = F.pad(x.to(dt).float(), (0, 0, pad[0], pad[1]))
        t = x.shape[-2]
        w = w.to(dt).float()
        acc = None
        for j in range(k):
            part = torch.einsum("...td,df->...tf", xp[..., j : j + t, :], w[j])
            acc = part if acc is None else acc + part
        return acc.to(dt) + b.to(dt)
    xp = F.pad(x.to(dt), (0, 0, pad[0], pad[1]))
    t = x.shape[-2]
    w = w.to(dt)
    out = sum(torch.einsum("...td,df->...tf", xp[..., j : j + t, :], w[j]) for j in range(k))
    return out + b.to(dt)


def _head_major(dropout_mask, heads: int):
    """The keep mask ``[B, N, Tq, H*Tk]`` (head h in columns [h*Tk, (h+1)*Tk))
    as ``[B, N, Tq, H, Tk]``."""
    b, n, t_q, cols = dropout_mask.shape
    return dropout_mask.reshape(b, n, t_q, heads, cols // heads)


def fused_temporal_attention_plain(mq, mk, vsrc, wq, bq, wk, bk, wv, bv, wo, bo,
                                   causal_q: bool, causal_kv: bool, is_mask: bool,
                                   heads: int, dtype_name: str = "float32", dropout_mask=None):
    """Plain PyTorch version (the JAX ``_ref_impl``; in bfloat16 the
    rounding points of the TPU ``_fwd_kernel``, :func:`_attention_core_bf16`).
    ``dropout_mask`` ``[B, N, Tq, H*Tk]`` float32, pre-scaled {0, 1/keep} and
    head-major, multiplies the float32 softmax weights before the value
    product (``_ref_impl(..., dropout_mask=)``)."""
    dt = _dt(dtype_name)
    if dt == torch.bfloat16:
        q = temporal_conv_plain(mq, wq, bq, causal_q, dt)
        k = temporal_conv_plain(mk, wk, bk, causal_kv, dt)
        v = temporal_conv_plain(vsrc, wv, bv, causal_kv, dt)
        x = _attention_core_bf16(q, k, v, is_mask, heads, dropout_mask)[0]
        return temporal_conv_plain(x, wo, bo, False, dt)
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
    attn = torch.softmax(scores, dim=-1)
    if dropout_mask is not None:
        attn = attn * _head_major(dropout_mask, heads).transpose(2, 3)
    x = torch.einsum("bnhqk,bnkhd->bnqhd", attn.to(dt), v).reshape(b, n, t_q, d)
    return temporal_conv_plain(x, wo, bo, False, dt)


def _attention_core_bf16(q, k, v, is_mask: bool, heads: int, dropout_mask=None):
    """softmax(q_h k_h^T / sqrt(dh)) v_h on bfloat16 q, k, v, as the TPU
    ``_blockdiag_state`` computes it: the scores in float32 times 1/sqrt(dh),
    the mask added, the row maximum taken over every head's scores of a
    query step, the exponentials summed per head and divided in float32;
    bf16(p) @ v accumulated in float32 and rounded to bfloat16. With a keep
    mask m the value product takes bf16(p m), the float32 product rounded
    once (not bf16(p) m: 1/keep is not a power of two). Returns
    ``(x [b, n, Tq, D] bfloat16, p [b, n, Tq, H, Tk] float32)``, p before
    dropout."""
    b, n, t_q, d = q.shape
    t_k = k.shape[-2]
    head_dim = d // heads
    s = torch.einsum("bnqhd,bnkhd->bnqhk", q.float().reshape(b, n, t_q, heads, head_dim),
                     k.float().reshape(b, n, t_k, heads, head_dim)) * (1.0 / math.sqrt(head_dim))
    if is_mask:
        above = torch.triu(torch.ones(t_q, t_k, dtype=torch.bool, device=s.device), diagonal=1)
        s = s + torch.where(above, torch.finfo(torch.float32).min, 0.0)[:, None, :]
    e = torch.exp(s - s.amax(dim=(-2, -1), keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    p_eff = p if dropout_mask is None else p * _head_major(dropout_mask, heads)
    x = torch.einsum("bnqhk,bnkhd->bnqhd", p_eff.to(torch.bfloat16).float(),
                     v.float().reshape(b, n, t_k, heads, head_dim))
    return x.to(torch.bfloat16).reshape(b, n, t_q, d), p


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
                                       heads: int, dtype_name: str = "float32",
                                       dropout_mask=None):
    """Plain PyTorch backward of :func:`fused_temporal_attention_plain` for
    the output cotangent ``g``: ``(dmq, dmk, dvsrc, dwq, dbq, dwk, dbk, dwv,
    dbv, dwo, dbo)``, written out as the TPU ``_bwd_kernel`` computes it
    (q, k, v and the softmax recomputed; float64 inputs stay float64). In
    bfloat16 see :func:`_bwd_plain_bf16`. With ``dropout_mask`` m (the
    ``_blockdiag_bwd`` of the dropout form): x_attn and dv from p m, dp
    multiplied by m, ds from the pre-dropout p."""
    if _dt(dtype_name) == torch.bfloat16:
        return _bwd_plain_bf16(mq, mk, vsrc, wq, bq, wk, bk, wv, bv, wo, bo, g, causal_q,
                               causal_kv, is_mask, heads, dropout_mask)
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
    m = None if dropout_mask is None else _head_major(dropout_mask, heads).transpose(2, 3)
    p_eff = p if m is None else p * m
    x_attn = torch.einsum("bnhqk,bnkhd->bnqhd", p_eff, vh).reshape(b, n, t_q, d)
    dwo, dbo = _conv_weight_grads_plain(x_attn, g, ks, False)
    dx_attn = _tconv_bwd_input_plain(g, wo, False).reshape(b, n, t_q, heads, head_dim)
    dp = torch.einsum("bnqhd,bnkhd->bnhqk", dx_attn, vh)
    if m is not None:
        dp = dp * m
    dv = torch.einsum("bnhqk,bnqhd->bnkhd", p_eff, dx_attn).reshape(b, n, t_k, d)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = (torch.einsum("bnhqk,bnkhd->bnqhd", ds, kh) * inv).reshape(b, n, t_q, d)
    dk = (torch.einsum("bnhqk,bnqhd->bnkhd", ds, qh) * inv).reshape(b, n, t_k, d)
    dwq, dbq = _conv_weight_grads_plain(mq, dq, ks, causal_q)
    dwk, dbk = _conv_weight_grads_plain(mk, dk, ks, causal_kv)
    dwv, dbv = _conv_weight_grads_plain(vsrc, dv, ks, causal_kv)
    return (_tconv_bwd_input_plain(dq, wq, causal_q), _tconv_bwd_input_plain(dk, wk, causal_kv),
            _tconv_bwd_input_plain(dv, wv, causal_kv), dwq, dbq, dwk, dbk, dwv, dbv, dwo, dbo)


def _bwd_plain_bf16(mq, mk, vsrc, wq, bq, wk, bk, wv, bv, wo, bo, g, causal_q: bool,
                    causal_kv: bool, is_mask: bool, heads: int, dropout_mask=None):
    """The bfloat16 backward at the rounding points of the TPU
    ``_bwd_kernel`` (``dtype_name="bfloat16"``, its block-diagonal middle):

    - q, k, v recomputed as the bfloat16 forward computes them, x_attn =
      bf16(bf16(p) v) with the float32 p of the row maximum over every head;
    - dWo, dbo from bf16(x_attn) and bf16(g), float32 sums; dx_attn =
      bf16(g) bf16(Wo)^T summed in float32 and kept float32;
    - dv, dp, ds, dq and dk in float32 on the float32 p (with a keep mask
      m: x_attn = bf16(bf16(p m) v), dv from the float32 p m, dp times m,
      ds from the pre-dropout p);
    - dq, dk and dv rounded to bfloat16 where they enter products: the
      weight gradients (bf16(input) times the rounded gradient, the bias
      gradients summing the rounded values in float32) and the input
      gradients (bf16(d) bf16(W)^T summed in float32), which go out in
      their inputs' dtypes.

    The weight and bias gradients are float32."""
    bf = torch.bfloat16
    r = lambda a: a.to(bf).float()  # noqa: E731  (round to bfloat16, compute in float32)
    ks = wq.shape[0]
    q = temporal_conv_plain(mq, wq, bq, causal_q, bf)
    k = temporal_conv_plain(mk, wk, bk, causal_kv, bf)
    v = temporal_conv_plain(vsrc, wv, bv, causal_kv, bf)
    b, n, t_q, d = q.shape
    t_k = k.shape[-2]
    head_dim = d // heads
    x_attn, p = _attention_core_bf16(q, k, v, is_mask, heads, dropout_mask)
    g = r(g)
    dwo, dbo = _conv_weight_grads_plain(x_attn.float(), g, ks, False)
    dx_attn = _tconv_bwd_input_plain(g, r(wo), False).reshape(b, n, t_q, heads, head_dim)
    qh, kh, vh = (a.float().reshape(b, n, -1, heads, head_dim) for a in (q, k, v))
    m = None if dropout_mask is None else _head_major(dropout_mask, heads)
    dv = torch.einsum("bnqhk,bnqhd->bnkhd", p if m is None else p * m, dx_attn)
    dp = torch.einsum("bnqhd,bnkhd->bnqhk", dx_attn, vh)
    if m is not None:
        dp = dp * m
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * (1.0 / math.sqrt(head_dim))
    dq = torch.einsum("bnqhk,bnkhd->bnqhd", ds, kh)
    dk = torch.einsum("bnqhk,bnqhd->bnkhd", ds, qh)
    dq, dk, dv = (r(a.reshape(b, n, -1, d)) for a in (dq, dk, dv))
    dwq, dbq = _conv_weight_grads_plain(r(mq), dq, ks, causal_q)
    dwk, dbk = _conv_weight_grads_plain(r(mk), dk, ks, causal_kv)
    dwv, dbv = _conv_weight_grads_plain(r(vsrc), dv, ks, causal_kv)
    return (_tconv_bwd_input_plain(dq, r(wq), causal_q).to(mq.dtype),
            _tconv_bwd_input_plain(dk, r(wk), causal_kv).to(mk.dtype),
            _tconv_bwd_input_plain(dv, r(wv), causal_kv).to(vsrc.dtype),
            dwq, dbq, dwk, dbk, dwv, dbv, dwo, dbo)


def fused_temporal_attention_kernel(mq, mk, vsrc, wq, bq, wk, bk, wv, bv, wo, bo,
                                    causal_q: bool, causal_kv: bool, is_mask: bool,
                                    heads: int, dropout_mask=None):
    """The CUDA forward kernel (float32, no autograd). At D3STN's shapes (T =
    12, K = 3, head dim 16, D = 128 with 8 heads or D = 64 with 4, its three
    flag sets) one call launches the weight-bank split and the tensor-core
    ``attn_fwd_d3stn_kernel`` and counts once; other shapes take the generic
    CUDA-core kernel (:func:`f32_fwd_route`). With ``dropout_mask``
    (:func:`fused_temporal_attention_plain`) it launches the dropout form of
    the D3STN kernel, at D3STN's shapes only, and counts under
    ``attn_fwd_dropout``."""
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
    route = f32_fwd_route(mq, mk, wq, causal_q, causal_kv, is_mask, heads,
                          dropout_mask is not None)
    if dropout_mask is not None:
        dropout_mask = _check_mask(dropout_mask, mq, mk, heads)
    lib = _build.library("attn")
    smem = lib.pxt_attn_fwd_smem_bytes(t_q, t_k, d, heads)
    if route == "generic" and smem > 232448:
        raise ValueError(f"D={d}, T={t_q}/{t_k} needs {smem} B of shared memory (> 227 KB)")
    arrays = [a.contiguous() for a in arrays]
    ptrs = (ctypes.c_void_p * 11)(*[a.data_ptr() for a in arrays])
    out = torch.empty_like(arrays[0])
    flags = (int(causal_q), int(causal_kv), int(is_mask))
    lib.pxt_attn_fwd_scratch_floats.restype = ctypes.c_int64
    lib.pxt_attn_fwd_scratch_floats.argtypes = [ctypes.c_int] * 8
    # the D3STN kernel's split weight banks
    scratch = torch.empty(lib.pxt_attn_fwd_scratch_floats(t_q, t_k, d, heads, ks, *flags),
                          dtype=torch.float32, device=mq.device)
    drop = dropout_mask is not None
    fn = lib.pxt_attn_fwd_f32_dropout if drop else lib.pxt_attn_fwd_f32
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * (4 if drop else 3) + [ctypes.c_int64]
                   + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    mask_ptr = (dropout_mask.data_ptr(),) if drop else ()
    with torch.cuda.device(mq.device):
        stream = torch.cuda.current_stream(mq.device).cuda_stream
        code = fn(ptrs, *mask_ptr, out.data_ptr(), scratch.data_ptr(), b * n, t_q, t_k, d,
                  heads, ks, *flags, stream)
    _build.check(lib, code, "attn_fwd_kernel")
    _build.LAUNCHES["attn_fwd_dropout" if drop else "attn_fwd"] += 1
    return out


# D3STN's flag sets (causal_q, causal_kv, is_mask): encoder self-attention,
# decoder masked self-attention, decoder source attention
_BWD_FLAGS = ((False, False, False), (True, True, True), (True, False, False))


def _is_d3stn_shape(mq, mk, wq, causal_q, causal_kv, is_mask, heads) -> bool:
    """T = 12, K = 3, head dim 16 with D = 128 (8 heads) or 64 (4 heads), and
    one of D3STN's three flag sets (``fast::covers`` in ``csrc/attn.cu``)."""
    d, t_q, t_k, ks = mq.shape[-1], mq.shape[-2], mk.shape[-2], wq.shape[0]
    flags = (bool(causal_q), bool(causal_kv), bool(is_mask))
    return (t_q == t_k == 12 and ks == 3 and d in (64, 128) and heads == d // 16
            and flags in _BWD_FLAGS)


def _check_d3stn_shape(kernel, mq, mk, wq, causal_q, causal_kv, is_mask, heads, other):
    if not _is_d3stn_shape(mq, mk, wq, causal_q, causal_kv, is_mask, heads):
        d, t_q, t_k, ks = mq.shape[-1], mq.shape[-2], mk.shape[-2], wq.shape[0]
        flags = (bool(causal_q), bool(causal_kv), bool(is_mask))
        raise ValueError(
            f"the {kernel} kernel takes T = 12, K = 3, head dim 16 with "
            "D = 128 (8 heads) or 64 (4 heads) and D3STN's three flag sets; got "
            f"mq {tuple(mq.shape)}, mk {tuple(mk.shape)}, K={ks}, heads={heads}, "
            f"(causal_q, causal_kv, is_mask)={flags}; attn_impl=\"xla\" {other}"
        )


def f32_fwd_route(mq, mk, wq, causal_q: bool, causal_kv: bool, is_mask: bool, heads: int,
                  dropout: bool = False) -> str:
    """Which CUDA kernel :func:`fused_temporal_attention_kernel` launches for
    these shapes (read from the shapes alone, on any device): ``"d3stn"``,
    the tensor-core ``attn_fwd_d3stn_kernel`` (D3STN's shapes, with or
    without ``dropout``), or ``"generic"``, the CUDA-core ``attn_fwd_kernel``
    (D a multiple of 32 up to 1024 split evenly over the heads, T <= 16; it
    has no dropout form). A shape that neither takes raises a
    ``ValueError`` naming ``attn_impl="xla"``."""
    if _is_d3stn_shape(mq, mk, wq, causal_q, causal_kv, is_mask, heads):
        return "d3stn"
    if dropout:
        _check_d3stn_shape("float32 attention dropout", mq, mk, wq, causal_q, causal_kv,
                           is_mask, heads, "runs other shapes")
    d, t_q, t_k = mq.shape[-1], mq.shape[-2], mk.shape[-2]
    if d % 32 or d > 1024 or d % heads or t_q > 16 or t_k > 16:
        raise ValueError(
            f"the attention kernel takes D a multiple of 32 (<= 1024) split "
            f"evenly over heads and T <= 16; got D={d}, heads={heads}, "
            f"Tq={t_q}, Tk={t_k}; attn_impl=\"xla\" runs other shapes"
        )
    return "generic"


def _check_like(mq, acts, weights):
    """``acts`` (mk, vsrc, and g in a backward) shaped as ``mq``; ``weights``
    the four convs' [K, D, D] kernels and [D] biases, interleaved."""
    d, ks = mq.shape[-1], weights[0].shape[0]
    for a in acts:
        if a.shape != mq.shape:
            raise ValueError(f"mk/vsrc/g {tuple(a.shape)} do not match mq {tuple(mq.shape)}")
    for w in weights[0::2]:
        if w.shape != (ks, d, d):
            raise ValueError(f"conv weights must be [{ks}, {d}, {d}], got {tuple(w.shape)}")
    for bias in weights[1::2]:
        if bias.shape != (d,):
            raise ValueError(f"conv biases must be [{d}], got {tuple(bias.shape)}")


def _check_mask(dropout_mask, mq, mk, heads):
    """The keep mask ``[B, N, Tq, H*Tk]`` float32 on mq's device, contiguous."""
    want = (*mq.shape[:3], heads * mk.shape[2])
    if tuple(dropout_mask.shape) != want:
        raise ValueError(f"dropout_mask must be {list(want)} (head-major), got "
                         f"{tuple(dropout_mask.shape)}")
    if dropout_mask.dtype != torch.float32 or dropout_mask.device != mq.device:
        raise TypeError(f"dropout_mask must be float32 on {mq.device}, got "
                        f"{dropout_mask.dtype} on {dropout_mask.device}")
    return dropout_mask.contiguous()


def _check_bwd_shape(mq, mk, wq, causal_q, causal_kv, is_mask, heads):
    _check_d3stn_shape("attention backward", mq, mk, wq, causal_q, causal_kv, is_mask, heads,
                       "trains it")


def fused_temporal_attention_bf16_kernel(mq, mk, vsrc, wq, bq, wk, bk, wv, bv, wo, bo,
                                         causal_q: bool, causal_kv: bool, is_mask: bool,
                                         heads: int, dropout_mask=None):
    """The CUDA forward kernel in bfloat16 (no autograd): activations
    float32 or bfloat16, weights float32; returns bfloat16. One call
    launches the weight cast and the fused kernel (``csrc/attn_bf16.cu``)
    and counts once; with ``dropout_mask`` its dropout form, counted under
    ``attn_fwd_bf16_dropout``."""
    arrays = (mq, mk, vsrc, wq, bq, wk, bk, wv, bv, wo, bo)
    if not mq.is_cuda:
        raise ValueError("fused_temporal_attention_bf16_kernel needs CUDA tensors")
    if any(a.dtype not in (torch.float32, torch.bfloat16) for a in arrays[:3]) or any(
            a.dtype != torch.float32 for a in arrays[3:]):
        raise TypeError("the bfloat16 attention kernel takes float32 or bfloat16 inputs "
                        "and float32 weights")
    _check_d3stn_shape("bfloat16 attention", mq, mk, wq, causal_q, causal_kv, is_mask, heads,
                       "runs other shapes")
    b, n, t_len, d = mq.shape
    ks = wq.shape[0]
    _check_like(mq, (mk, vsrc), arrays[3:])
    drop = dropout_mask is not None
    if drop:
        dropout_mask = _check_mask(dropout_mask, mq, mk, heads)
    # a bfloat16 activation converts exactly; the kernel rounds float32 ones
    arrays = [a.float().contiguous() for a in arrays]
    out = torch.empty(mq.shape, dtype=torch.bfloat16, device=mq.device)
    rows = b * n
    if not rows:
        return out
    # the four weight banks in bfloat16, in the order the tensor cores read them
    scratch = torch.empty(4 * ks * d * d, dtype=torch.bfloat16, device=mq.device)
    lib = _build.library("attn_bf16")
    ptrs = (ctypes.c_void_p * 11)(*[a.data_ptr() for a in arrays])
    fn = lib.pxt_attn_fwd_bf16_dropout if drop else lib.pxt_attn_fwd_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * (4 if drop else 3) + [ctypes.c_int64]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    mask_ptr = (dropout_mask.data_ptr(),) if drop else ()
    with torch.cuda.device(mq.device):
        stream = torch.cuda.current_stream(mq.device).cuda_stream
        code = fn(ptrs, *mask_ptr, out.data_ptr(), scratch.data_ptr(), rows, d, int(causal_q),
                  int(causal_kv), int(is_mask), stream)
    _build.check(lib, code, "attn_bf16_fwd_kernel")
    _build.LAUNCHES["attn_fwd_bf16_dropout" if drop else "attn_fwd_bf16"] += 1
    return out


def fused_temporal_attention_bwd_kernel(mq, mk, vsrc, wq, bq, wk, bk, wv, bv, wo, bo, g,
                                        causal_q: bool, causal_kv: bool, is_mask: bool,
                                        heads: int, dropout_mask=None):
    """The CUDA backward kernels: the 11 gradients of
    :func:`fused_temporal_attention_plain` for the output cotangent ``g``, in
    float32. One call launches the weight-bank split, the q/k/v/dx_attn
    convs, the attention core, the input-gradient convs, the split
    weight-gradient products and their fixed-order sum (``csrc/attn_bwd.cu``)
    and counts once; with ``dropout_mask`` the core's dropout form, counted
    under ``attn_bwd_dropout``."""
    arrays = (mq, mk, vsrc, wq, bq, wk, bk, wv, bv, wo, bo, g)
    if not mq.is_cuda:
        raise ValueError("fused_temporal_attention_bwd_kernel needs CUDA tensors")
    if any(a.dtype != torch.float32 for a in arrays):
        raise TypeError("the attention backward kernel takes float32 inputs, weights and g")
    _check_bwd_shape(mq, mk, wq, causal_q, causal_kv, is_mask, heads)
    b, n, t_len, d = mq.shape
    ks = wq.shape[0]
    _check_like(mq, (mk, vsrc, g), (wq, bq, wk, bk, wv, bv, wo, bo))
    drop = dropout_mask is not None
    if drop:
        dropout_mask = _check_mask(dropout_mask, mq, mk, heads)
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
        fn = lib.pxt_attn_bwd_f32_dropout if drop else lib.pxt_attn_bwd_f32
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * (4 if drop else 3) + [ctypes.c_int64]
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        mask_ptr = (dropout_mask.data_ptr(),) if drop else ()
        with torch.cuda.device(mq.device):
            stream = torch.cuda.current_stream(mq.device).cuda_stream
            code = fn(ptrs, *mask_ptr, outs, scratch.data_ptr(), rows, splits, d, int(causal_q),
                      int(causal_kv), int(is_mask), stream)
        _build.check(lib, code, "attn_bwd kernels")
        _build.LAUNCHES["attn_bwd_dropout" if drop else "attn_bwd"] += 1
    dws = [dw[i * bank : (i + 1) * bank].view(ks, d, d) for i in range(4)]
    dbs = [dw[4 * bank + i * d : 4 * bank + (i + 1) * d] for i in range(4)]
    return (*dacts, dws[0], dbs[0], dws[1], dbs[1], dws[2], dbs[2], dws[3], dbs[3])


# K5 bf16's weight-gradient kernel (csrc/attn_bwd_bf16.cu): tiles of 8 rows,
# one CTA of 64 input channels per (split, weight), one CTA per SM
_DW_TILE_ROWS = 8
_DW_CHANNELS = 64


def bf16_dw_splits(rows: int, d: int, sms: int) -> int:
    """The number of row splits of K5 bf16's weight-gradient kernel: one
    wave of its ``4 * d / 64`` CTAs per split on ``sms`` SMs, at most one
    split per tile of 8 rows, and none empty. The kernel gives split ``s``
    the tiles ``s * per .. (s + 1) * per - 1``, ``per = ceil(tiles /
    splits)``."""
    tiles = -(-rows // _DW_TILE_ROWS)
    splits = max(1, min(sms // (4 * (d // _DW_CHANNELS)), tiles))
    return -(-tiles // -(-tiles // splits))


# K5 bf16's conv kernel (csrc/attn_bwd_bf16.cu): persistent, one CTA per
# SM, each CTA on one job's tiles of 16 rows
_CONV_TILE_ROWS = 16


def bf16_conv_ctas(rows: int, jobs: int, sms: int) -> int:
    """CTAs per job of K5 bf16's conv kernel launched with ``jobs`` convs
    (4: q, k, v, dx_attn; 3: dmq, dmk, dvs): the SMs shared out over the
    jobs, at least one and at most one per tile of 16 rows. CTA ``c`` of a
    job takes the job's tiles ``c, c + ctas, c + 2 ctas, ...``."""
    tiles = -(-rows // _CONV_TILE_ROWS)
    return max(1, min(sms // jobs, tiles))


def fused_temporal_attention_bwd_bf16_kernel(mq, mk, vsrc, wq, bq, wk, bk, wv, bv, wo, bo, g,
                                             causal_q: bool, causal_kv: bool, is_mask: bool,
                                             heads: int, dropout_mask=None):
    """The CUDA backward kernels in bfloat16: the 11 gradients of
    :func:`fused_temporal_attention_plain` in bfloat16 for the cotangent
    ``g``, at the rounding points of :func:`_bwd_plain_bf16`. Activations
    float32 or bfloat16 (each gradient goes out in its input's dtype),
    weights float32 (their gradients float32), ``g`` bfloat16 (a float32 g
    is rounded first, as the TPU kernel rounds it where it enters each
    product). One call launches the weight cast, the conv kernel for the
    q/k/v/dx_attn convs, the attention core, the conv kernel again for the
    input-gradient convs, the split weight-gradient products and their
    fixed-order sum (``csrc/attn_bwd_bf16.cu``) and counts once; with ``dropout_mask`` the core's dropout form, counted under
    ``attn_bwd_bf16_dropout``."""
    if not mq.is_cuda:
        raise ValueError("fused_temporal_attention_bwd_bf16_kernel needs CUDA tensors")
    acts = (mq, mk, vsrc)
    weights = (wq, bq, wk, bk, wv, bv, wo, bo)
    if any(a.dtype not in (torch.float32, torch.bfloat16) for a in (*acts, g)) or any(
            w.dtype != torch.float32 for w in weights):
        raise TypeError("the bfloat16 attention backward kernel takes float32 or bfloat16 "
                        "inputs and g and float32 weights")
    _check_d3stn_shape("bfloat16 attention backward", mq, mk, wq, causal_q, causal_kv, is_mask,
                       heads, "trains other shapes")
    b, n, t_len, d = mq.shape
    ks = wq.shape[0]
    _check_like(mq, (mk, vsrc, g), weights)
    drop = dropout_mask is not None
    if drop:
        dropout_mask = _check_mask(dropout_mask, mq, mk, heads)
    # a bfloat16 activation converts exactly; the kernels round float32 ones
    arrays = ([a.float().contiguous() for a in acts] + [w.contiguous() for w in weights]
              + [g.to(torch.bfloat16).contiguous()])
    bank = ks * d * d
    dw = torch.empty(4 * bank + 4 * d, dtype=torch.float32, device=mq.device)
    dacts = [torch.empty_like(arrays[i]) for i in range(3)]
    rows = b * n
    if not rows:
        dw.zero_()
    else:
        sms = torch.cuda.get_device_properties(mq.device).multi_processor_count
        splits = bf16_dw_splits(rows, d, sms)
        lib = _build.library("attn_bwd_bf16")
        lib.pxt_attn_bwd_bf16_scratch_bytes.restype = ctypes.c_int64
        lib.pxt_attn_bwd_bf16_scratch_bytes.argtypes = [ctypes.c_int64, ctypes.c_int,
                                                        ctypes.c_int]
        scratch = torch.empty(lib.pxt_attn_bwd_bf16_scratch_bytes(rows, splits, d),
                              dtype=torch.uint8, device=mq.device)
        ptrs = (ctypes.c_void_p * 12)(*[a.data_ptr() for a in arrays])
        outs = (ctypes.c_void_p * 4)(*[a.data_ptr() for a in dacts], dw.data_ptr())
        fn = lib.pxt_attn_bwd_bf16_dropout if drop else lib.pxt_attn_bwd_bf16
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * (4 if drop else 3) + [ctypes.c_int64]
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        mask_ptr = (dropout_mask.data_ptr(),) if drop else ()
        with torch.cuda.device(mq.device):
            stream = torch.cuda.current_stream(mq.device).cuda_stream
            code = fn(ptrs, *mask_ptr, outs, scratch.data_ptr(), rows, splits,
                      bf16_conv_ctas(rows, 4, sms), bf16_conv_ctas(rows, 3, sms), d,
                      int(causal_q), int(causal_kv), int(is_mask), stream)
        _build.check(lib, code, "attn_bwd_bf16 kernels")
        _build.LAUNCHES["attn_bwd_bf16_dropout" if drop else "attn_bwd_bf16"] += 1
    dacts = [a.to(x.dtype) for a, x in zip(dacts, acts)]
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


class _FusedTemporalAttentionBf16(torch.autograd.Function):
    """The bfloat16 block with the TPU ``_bwd_kernel``'s rounding points in
    its backward: on the card K4 and K5 in bfloat16 (``kernel``), elsewhere
    their plain versions. Gradients go out in their inputs' dtypes."""

    @staticmethod
    def forward(ctx, mq, mk, vsrc, wq, bq, wk, bk, wv, bv, wo, bo, causal_q, causal_kv,
                is_mask, heads, kernel):
        ctx.save_for_backward(mq, mk, vsrc, wq, bq, wk, bk, wv, bv, wo, bo)
        ctx.statics = (causal_q, causal_kv, is_mask, heads)
        ctx.kernel = kernel
        args = (mq, mk, vsrc, wq, bq, wk, bk, wv, bv, wo, bo, causal_q, causal_kv, is_mask, heads)
        if kernel:
            return fused_temporal_attention_bf16_kernel(*args)
        return fused_temporal_attention_plain(*args, "bfloat16")

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        if ctx.kernel:
            grads = fused_temporal_attention_bwd_bf16_kernel(*saved, g, *ctx.statics)
        else:
            grads = fused_temporal_attention_bwd_plain(*saved, g, *ctx.statics, "bfloat16")
        grads = [a.to(x.dtype) for a, x in zip(grads, saved)]
        return (*grads, None, None, None, None, None)


def _use_kernel(mq, impl: str, dtype_name: str) -> bool:
    """Whether ``impl`` ("auto", "xla", "pallas") takes the kernels for mq."""
    if impl not in _IMPLS:
        raise ValueError(f"impl={impl!r} not in {_IMPLS}")
    kernel = impl == "pallas" or (impl == "auto" and mq.is_cuda)
    if kernel and not mq.is_cuda:
        raise ValueError("attn_impl='pallas' needs CUDA tensors (the kernel runs on the card)")
    if kernel and dtype_name not in ("float32", "bfloat16"):
        raise NotImplementedError(
            f"the attention kernels take float32 or bfloat16, not {dtype_name!r}")
    return kernel


def fused_temporal_attention(mq, mk, vsrc, wq, bq, wk, bk, wv, bv, wo, bo,
                             causal_q: bool, causal_kv: bool, is_mask: bool,
                             heads: int, dtype_name: str = "float32",
                             impl: str = "auto"):
    """Fused conv -> MHA -> conv over ``[B, N, T, D]``; weights are the four
    convs' ``[K, D, D]`` kernels and ``[D]`` biases; ``impl`` in
    ("auto", "xla", "pallas"). In bfloat16 with gradients both routes go
    through :class:`_FusedTemporalAttentionBf16`, whose backward follows the
    TPU kernel's rounding points."""
    args = (mq, mk, vsrc, wq, bq, wk, bk, wv, bv, wo, bo, causal_q, causal_kv, is_mask, heads)
    kernel = _use_kernel(mq, impl, dtype_name)
    training = torch.is_grad_enabled() and any(a.requires_grad for a in args[:11])
    if dtype_name == "bfloat16" and training:
        if kernel:
            _check_d3stn_shape("bfloat16 attention backward", mq, mk, wq, causal_q, causal_kv,
                               is_mask, heads, "trains other shapes")
        return _FusedTemporalAttentionBf16.apply(*args, kernel)
    if not kernel:
        return fused_temporal_attention_plain(*args, dtype_name)
    if dtype_name == "bfloat16":
        return fused_temporal_attention_bf16_kernel(*args)
    if not training:
        return fused_temporal_attention_kernel(*args)  # no autograd node
    _check_bwd_shape(mq, mk, wq, causal_q, causal_kv, is_mask, heads)
    return _FusedTemporalAttention.apply(*args)


class _FusedTemporalAttentionDropout(torch.autograd.Function):
    """The block with a keep mask (``_vjp_fwd_dropout``/``_vjp_bwd_dropout``
    of the JAX file): the mask is saved and replayed in the backward and
    gets no gradient. On the card the dropout forms of K4 and K5
    (``kernel``), elsewhere their plain versions; in float32 or bfloat16.
    Gradients go out in their inputs' dtypes."""

    @staticmethod
    def forward(ctx, mq, mk, vsrc, wq, bq, wk, bk, wv, bv, wo, bo, dropout_mask, causal_q,
                causal_kv, is_mask, heads, dtype_name, kernel):
        ctx.save_for_backward(mq, mk, vsrc, wq, bq, wk, bk, wv, bv, wo, bo, dropout_mask)
        ctx.statics = (causal_q, causal_kv, is_mask, heads)
        ctx.dtype_name, ctx.kernel = dtype_name, kernel
        args = (mq, mk, vsrc, wq, bq, wk, bk, wv, bv, wo, bo, causal_q, causal_kv, is_mask, heads)
        if not kernel:
            return fused_temporal_attention_plain(*args, dtype_name, dropout_mask)
        if dtype_name == "bfloat16":
            return fused_temporal_attention_bf16_kernel(*args, dropout_mask)
        return fused_temporal_attention_kernel(*args, dropout_mask)

    @staticmethod
    def backward(ctx, g):
        *saved, dropout_mask = ctx.saved_tensors
        if not ctx.kernel:
            grads = fused_temporal_attention_bwd_plain(*saved, g, *ctx.statics, ctx.dtype_name,
                                                       dropout_mask)
        elif ctx.dtype_name == "bfloat16":
            grads = fused_temporal_attention_bwd_bf16_kernel(*saved, g, *ctx.statics,
                                                             dropout_mask)
        else:
            grads = fused_temporal_attention_bwd_kernel(*saved, g, *ctx.statics, dropout_mask)
        grads = [a.to(x.dtype) for a, x in zip(grads, saved)]
        return (*grads, None, None, None, None, None, None, None)


def fused_temporal_attention_dropout(mq, mk, vsrc, wq, bq, wk, bk, wv, bv, wo, bo,
                                     dropout_mask, causal_q: bool, causal_kv: bool,
                                     is_mask: bool, heads: int, dtype_name: str = "float32",
                                     impl: str = "auto"):
    """:func:`fused_temporal_attention` with attention-weight dropout (the
    JAX ``fused_temporal_attention_dropout``). ``dropout_mask`` ``[B, N, Tq,
    H*Tk]`` float32 holds the pre-scaled keep weights {0, 1/keep}, head h in
    columns [h*Tk, (h+1)*Tk); the caller draws it, the forward multiplies
    the softmax weights by it and the backward replays it. On the card the
    kernels take D3STN's shapes (T = 12, K = 3, head dim 16, D = 128 or 64,
    its three flag sets) in float32 and bfloat16; other shapes raise a
    ``ValueError`` naming ``attn_impl="xla"``."""
    kernel = _use_kernel(mq, impl, dtype_name)
    arrays = (mq, mk, vsrc, wq, bq, wk, bk, wv, bv, wo, bo)
    if kernel and torch.is_grad_enabled() and any(a.requires_grad for a in arrays):
        _check_d3stn_shape("attention dropout backward", mq, mk, wq, causal_q, causal_kv,
                           is_mask, heads, "trains other shapes")
    return _FusedTemporalAttentionDropout.apply(*arrays, dropout_mask, causal_q, causal_kv,
                                                is_mask, heads, dtype_name, kernel)
