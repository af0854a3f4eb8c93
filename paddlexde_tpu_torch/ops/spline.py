"""Fused cubic-Hermite gather-evaluation of a history series (kernel K1).

Counterpart of ``paddlexde_tpu/ops/spline_pallas.py``. ``hermite_gather_eval``
evaluates ``series [..., T, D]`` at fractional ``queries [L]`` over knots
``t [T]`` and returns ``[..., L, D]``, numerically the same function as
``CubicHermiteSpline(series, t).evaluate(queries)``. Gradients flow to the
queries only (the ``HistoryIndex`` contract): the lag gradient
``g_q[l] = sum over batch and features of g * dH/dq`` (:func:`lag_grad_plain`).

``hermite_gather_eval_pair`` evaluates the same series at two query sets
(a batch's decoder and encoder lags) in one launch, and its backward gives
both lag gradients in one launch. The JAX package calls its kernel once per
set; every output element is computed from the same operations either way.

A CUDA tensor goes to the hand-written kernels (``csrc/spline.cu``:
``hermite_gather_kernel``, counted under ``spline``, and
``hermite_lag_grad_kernel``, counted under ``spline_bwd``); a CPU tensor to
the plain PyTorch versions. Nothing falls back from one to the other.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from .._device import input_device, place
from . import _build

__all__ = ["hermite_gather_eval", "hermite_gather_eval_pair", "gather_eval_plain",
           "gather_eval_kernel", "gather_pair_kernel", "lag_grad_plain", "lag_grad_kernel"]


def _prep(series, t, queries):
    """Segment index [L] (int64), local offset frac [L] and width h [L]."""
    t = t.to(series.dtype).contiguous()
    queries = queries.to(series.dtype)
    max_idx = series.shape[-2] - 2
    idx = (torch.searchsorted(t, queries, right=True) - 1).clamp(0, max_idx)
    t0 = t[idx]
    t1 = t[(idx + 1).clamp(0, t.shape[0] - 1)]
    h = torch.where(t1 == t0, torch.ones_like(t0), t1 - t0)
    return idx, (queries - t0) / h, h


def _basis(frac, h, derivative: bool):
    x = frac
    x2 = x * x
    if derivative:
        return (
            (6 * x2 - 6 * x) / h,
            3 * x2 - 4 * x + 1,
            (-6 * x2 + 6 * x) / h,
            3 * x2 - 2 * x,
        )
    x3 = x2 * x
    return (
        2 * x3 - 3 * x2 + 1,
        (x3 - 2 * x2 + x) * h,
        -2 * x3 + 3 * x2,
        (x3 - x2) * h,
    )


def gather_eval_plain(series, t, queries, derivative: bool = False):
    """Plain PyTorch version: slopes over the whole series, then gather."""
    t = t.to(series.dtype)
    idx, frac, h = _prep(series, t, queries)
    c_p0, c_m0, c_p1, c_m1 = _basis(frac, h, derivative)
    dt = t[1:] - t[:-1]
    m = (series[..., 1:, :] - series[..., :-1, :]) / dt[:, None]
    m = torch.cat([m, m[..., -1:, :]], dim=-2)
    p0 = series.index_select(-2, idx)
    p1 = series.index_select(-2, idx + 1)
    m0 = m.index_select(-2, idx)
    m1 = m.index_select(-2, idx + 1)
    e = lambda v: v[:, None]
    return e(c_p0) * p0 + e(c_m0) * m0 + e(c_p1) * p1 + e(c_m1) * m1


def lag_grad_plain(series, t, queries, g):
    """Plain version of the lag gradient: ``g [..., L, D]`` times the
    derivative basis, summed over every axis but the queries'."""
    deriv = gather_eval_plain(series, t, queries, derivative=True)
    dims = tuple(range(deriv.dim() - 2)) + (deriv.dim() - 1,)
    return (g * deriv).sum(dim=dims).to(queries.dtype)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGTYPES = {
    "gather": [_P] * 6 + [_I64] + [_I] * 5 + [_P],
    "lag_grad": [_P] * 10 + [_I64] + [_I] * 4 + [_P],
    "ctas": [_I64],  # CTAs of a lag-gradient launch (its partial sums)
}
_fns = {}  # (entry, dtype) -> the C function, its argtypes set once
_tickets = {}  # (device, stream) -> the lag-gradient kernel's int32 ticket


def _fn(entry: str, dtype):
    fn = _fns.get((entry, dtype))
    if fn is None:
        lib = _build.library("spline")
        suffix = "" if dtype is None else "_f32" if dtype == torch.float32 else "_f64"
        fn = getattr(lib, f"pxt_hermite_{entry}{suffix}")
        fn.argtypes, fn.restype = _ARGTYPES[entry], ctypes.c_int
        _fns[(entry, dtype)] = fn
    return fn


def _like(v, x):
    """``v`` as a contiguous tensor of ``x``'s device and dtype: ``v`` itself
    when it is one already."""
    if not (isinstance(v, torch.Tensor) and v.device == x.device and v.dtype == x.dtype
            and v.is_contiguous()):
        v = torch.as_tensor(v).to(x.device, x.dtype).contiguous()
    return v


def _on(dev):
    """The card of ``dev`` as the current device, switched only when it is
    not already."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def _stream(dev) -> int:
    """The current CUDA stream of ``dev`` as a pointer (no Stream object)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def _series(series, who: str):
    if not series.is_cuda:
        raise ValueError(f"{who} needs a CUDA tensor")
    if series.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"spline kernel takes float32/float64, got {series.dtype}")
    if series.dim() < 2 or series.shape[-2] < 2:
        raise ValueError(f"series [..., T>=2, D] expected, got {tuple(series.shape)}")
    return series if series.is_contiguous() else series.contiguous()


def _knots(x, t):
    t = _like(t, x)
    if t.shape != (x.shape[-2],):
        raise ValueError(f"knots t {tuple(t.shape)} must be [{x.shape[-2]}]")
    return t


def _queries(x, queries):
    queries = _like(queries, x)
    if queries.dim() != 1:
        raise ValueError(f"queries must be 1-D, got {tuple(queries.shape)}")
    return queries


def _ptr(v):
    return 0 if v is None else v.data_ptr()


def gather_pair_kernel(series, t, queries_a, queries_b, derivative: bool = False):
    """The CUDA kernel on the native ``[..., T, D]`` layout at two query sets
    in one launch (``csrc/spline.cu``): ``(out_a [..., La, D], out_b [...,
    Lb, D])``. ``queries_b=None``: one set, ``out_b`` None."""
    x = _series(series, "gather_pair_kernel")
    t, qa = _knots(x, t), _queries(x, queries_a)
    qb = None if queries_b is None else _queries(x, queries_b)
    la, lb = qa.shape[0], 0 if qb is None else qb.shape[0]
    t_len, d = x.shape[-2], x.shape[-1]
    rows = x.numel() // (t_len * d) if d else 0
    lead = x.shape[:-2]
    out_a = torch.empty(lead + (la, d), dtype=x.dtype, device=x.device)
    out_b = None if qb is None else torch.empty(lead + (lb, d), dtype=x.dtype, device=x.device)
    fn = _fn("gather", x.dtype)
    with _on(x.device):
        code = fn(x.data_ptr(), t.data_ptr(), qa.data_ptr(), _ptr(qb), out_a.data_ptr(),
                  _ptr(out_b), rows, t_len, d, la, lb, int(derivative), _stream(x.device))
    _build.check(_build.library("spline"), code, "hermite_gather_kernel")
    _build.LAUNCHES["spline"] += 1
    return out_a, out_b


def gather_eval_kernel(series, t, queries, derivative: bool = False):
    """The CUDA kernel at one query set: :func:`gather_pair_kernel` with the
    second set empty."""
    return gather_pair_kernel(series, t, queries, None, derivative)[0]


def _ticket(dev, stream):
    key = (dev.index, stream)
    ticket = _tickets.get(key)
    if ticket is None:  # zeroed once; the kernel's last CTA sets it back to 0
        ticket = _tickets[key] = torch.zeros(1, dtype=torch.int32, device=dev)
    return ticket


def lag_grad_kernel(series, t, queries_a, g_a, queries_b=None, g_b=None):
    """Both lag gradients in one launch (``hermite_lag_grad_kernel``):
    ``(g_qa [La], g_qb [Lb])`` in the series' dtype, within the sum order
    of :func:`lag_grad_plain`; ``queries_b=None``: one set, ``g_qb`` None.
    The same bits on every call and on any card."""
    x = _series(series, "lag_grad_kernel")
    t, qa = _knots(x, t), _queries(x, queries_a)
    qb = None if queries_b is None else _queries(x, queries_b)
    la, lb = qa.shape[0], 0 if qb is None else qb.shape[0]
    t_len, d = x.shape[-2], x.shape[-1]
    lead = x.shape[:-2]
    ga = _like(g_a, x)
    gb = None if qb is None else _like(g_b, x)
    for g, n in ((ga, la), (gb, lb)):
        if g is not None and g.shape != lead + (n, d):
            raise ValueError(f"cotangent {tuple(g.shape)} must be {tuple(lead + (n, d))}")
    rows = x.numel() // (t_len * d) if d else 0
    partial = torch.empty(_fn("ctas", None)(rows) * (la + lb), dtype=torch.float64,
                          device=x.device)
    gq = torch.empty(la + lb, dtype=x.dtype, device=x.device)
    fn = _fn("lag_grad", x.dtype)
    with _on(x.device):
        stream = _stream(x.device)
        code = fn(x.data_ptr(), t.data_ptr(), qa.data_ptr(), _ptr(qb), ga.data_ptr(), _ptr(gb),
                  gq.data_ptr(), gq.data_ptr() + la * gq.element_size(), partial.data_ptr(),
                  _ticket(x.device, stream).data_ptr(), rows, t_len, d, la, lb, stream)
    _build.check(_build.library("spline"), code, "hermite_lag_grad_kernel")
    _build.LAUNCHES["spline_bwd"] += 1
    return gq[:la], (None if qb is None else gq[la:])


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class _HermiteGatherEval(torch.autograd.Function):
    @staticmethod
    def forward(ctx, series, t, queries):
        ctx.save_for_backward(series, t, queries)
        if series.is_cuda:
            return gather_eval_kernel(series, t, queries)
        return gather_eval_plain(series, t, queries)

    @staticmethod
    def backward(ctx, g):
        series, t, queries = ctx.saved_tensors
        if not ctx.needs_input_grad[2]:
            return None, None, None
        if series.is_cuda:
            return None, None, lag_grad_kernel(series, t, queries, g)[0].to(queries.dtype)
        return None, None, lag_grad_plain(series, t, queries, g)


class _HermiteGatherPair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, series, t, queries_a, queries_b):
        ctx.save_for_backward(series, t, queries_a, queries_b)
        if series.is_cuda:
            return gather_pair_kernel(series, t, queries_a, queries_b)
        return gather_eval_plain(series, t, queries_a), gather_eval_plain(series, t, queries_b)

    @staticmethod
    def backward(ctx, g_a, g_b):
        series, t, queries_a, queries_b = ctx.saved_tensors
        if not any(ctx.needs_input_grad[2:]):
            return None, None, None, None
        if series.is_cuda:
            gq_a, gq_b = lag_grad_kernel(series, t, queries_a, g_a, queries_b, g_b)
            gq_a, gq_b = gq_a.to(queries_a.dtype), gq_b.to(queries_b.dtype)
        else:
            gq_a = lag_grad_plain(series, t, queries_a, g_a)
            gq_b = lag_grad_plain(series, t, queries_b, g_b)
        return (None, None, gq_a if ctx.needs_input_grad[2] else None,
                gq_b if ctx.needs_input_grad[3] else None)


def _inputs(series, t, *queries):
    series = place(series, input_device(series, queries[0]))
    t = torch.as_tensor(t, device=series.device)
    return (series, t, *(torch.as_tensor(q, device=series.device) for q in queries))


def hermite_gather_eval(series, t, queries):
    """Cubic-Hermite evaluation of ``series [..., T, D]`` at ``queries [L]``;
    returns ``[..., L, D]``. Gradients reach ``queries`` only. A numpy/list
    ``series`` follows a tensor ``queries``, else goes to the card."""
    return _HermiteGatherEval.apply(*_inputs(series, t, queries))


def hermite_gather_eval_pair(series, t, queries_a, queries_b):
    """:func:`hermite_gather_eval` of one series at two query sets:
    ``(out_a [..., La, D], out_b [..., Lb, D])`` from one kernel launch on
    the card, and both lag gradients from one launch in the backward."""
    return _HermiteGatherPair.apply(*_inputs(series, t, queries_a, queries_b))
