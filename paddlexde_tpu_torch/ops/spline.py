"""Fused cubic-Hermite gather-evaluation of a history series (kernel K1).

Counterpart of ``paddlexde_tpu/ops/spline_pallas.py``. ``hermite_gather_eval``
evaluates ``series [..., T, D]`` at fractional ``queries [L]`` over knots
``t [T]`` and returns ``[..., L, D]``, numerically the same function as
``CubicHermiteSpline(series, t).evaluate(queries)``. Gradients flow to the
queries only (the ``HistoryIndex`` contract): the backward is the same
evaluation with the derivative basis, reduced over batch and features.

A CUDA tensor goes to the hand-written kernel (``csrc/spline.cu``); a CPU
tensor to the plain PyTorch version. Nothing falls back from one to the
other.
"""

from __future__ import annotations

import ctypes

import torch

from .._device import input_device, place
from . import _build

__all__ = ["hermite_gather_eval", "gather_eval_plain", "gather_eval_kernel"]


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


def gather_eval_kernel(series, t, queries, derivative: bool = False):
    """The CUDA kernel on the native ``[..., T, D]`` layout: one launch that
    locates the queries, forms the basis and evaluates (``csrc/spline.cu``)."""
    if not series.is_cuda:
        raise ValueError("gather_eval_kernel needs a CUDA tensor")
    if series.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"spline kernel takes float32/float64, got {series.dtype}")
    if series.dim() < 2 or series.shape[-2] < 2:
        raise ValueError(f"series [..., T>=2, D] expected, got {tuple(series.shape)}")
    t_len, d = series.shape[-2], series.shape[-1]
    t = t.to(series.device, series.dtype).contiguous()
    queries = queries.to(series.device, series.dtype).contiguous()
    if t.shape != (t_len,) or queries.dim() != 1:
        raise ValueError(
            f"knots t {tuple(t.shape)} must be [{t_len}] and queries 1-D, got {tuple(queries.shape)}"
        )
    x = series.contiguous()
    rows = x.numel() // (t_len * d)
    n_q = queries.shape[0]
    out = torch.empty(series.shape[:-2] + (n_q, d), dtype=x.dtype, device=x.device)
    lib = _build.library("spline")
    fn = lib.pxt_hermite_gather_f32 if x.dtype == torch.float32 else lib.pxt_hermite_gather_f64
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(x.data_ptr(), t.data_ptr(), queries.data_ptr(), out.data_ptr(), rows,
                  t_len, d, n_q, int(derivative), stream)
    _build.check(lib, code, "hermite_gather_kernel")
    _build.LAUNCHES["spline"] += 1
    return out


def _gather_eval(series, t, queries, derivative: bool):
    if series.is_cuda:
        return gather_eval_kernel(series, t, queries, derivative)
    return gather_eval_plain(series, t, queries, derivative)


class _HermiteGatherEval(torch.autograd.Function):
    @staticmethod
    def forward(ctx, series, t, queries):
        ctx.save_for_backward(series, t, queries)
        return _gather_eval(series, t, queries, derivative=False)

    @staticmethod
    def backward(ctx, g):
        series, t, queries = ctx.saved_tensors
        g_q = None
        if ctx.needs_input_grad[2]:
            deriv = _gather_eval(series, t, queries, derivative=True)
            dims = tuple(range(deriv.dim() - 2)) + (deriv.dim() - 1,)
            g_q = (g * deriv).sum(dim=dims).to(queries.dtype)
        return None, None, g_q


def hermite_gather_eval(series, t, queries):
    """Cubic-Hermite evaluation of ``series [..., T, D]`` at ``queries [L]``;
    returns ``[..., L, D]``. Gradients reach ``queries`` only. A numpy/list
    ``series`` follows a tensor ``queries``, else goes to the card."""
    series = place(series, input_device(series, queries))
    t = torch.as_tensor(t, device=series.device)
    queries = torch.as_tensor(queries, device=series.device)
    return _HermiteGatherEval.apply(series, t, queries)
