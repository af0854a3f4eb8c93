"""Step-size control and dense-output polynomial machinery.

Counterpart of ``paddlexde_tpu/utils/ode_utils.py`` (itself a rebuild of
``paddlexde/utils/ode_utils.py:22-109``). Every function here is a function
of tensors that stays on their device: the JAX version's ``jnp.where``
selects stay ``torch.where`` selects, never Python branches on device
values, so the adaptive engine reads nothing back from the card here.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils._pytree import tree_leaves, tree_map

from .norms import rms_norm

__all__ = [
    "sort_tvals",
    "interp_fit",
    "interp_evaluate",
    "compute_error_ratio",
    "optimal_step_size",
    "select_initial_step",
]


def sort_tvals(tvals, t0):
    """Keep ``tvals >= t0`` (the others become +inf) and sort ascending.

    Static-shaped like the JAX version: entries before ``t0`` are pushed to
    +inf instead of dropped, so a "next point" search skips them."""
    tvals = torch.as_tensor(tvals)
    tvals = torch.where(tvals >= t0, tvals, torch.full_like(tvals, float("inf")))
    return torch.sort(tvals).values


def interp_fit(y0, y1, y_mid, f0, f1, dt):
    """Quartic fit over one solver step: ``[e, d, c, b, a]`` for
    ``p(x) = a x^4 + b x^3 + c x^2 + d x + e``, ``x in [0, 1]`` across the
    step; each coefficient is a tree shaped like the state."""

    def _d(x):
        return torch.as_tensor(dt).to(x.dtype)

    e = y0
    d = tree_map(lambda f0: _d(f0) * f0, f0)
    c = tree_map(
        lambda y0, y1, ym, f0, f1: _d(y0) * (f1 - 4 * f0) - 11 * y0 - 5 * y1 + 16 * ym,
        y0, y1, y_mid, f0, f1,
    )
    b = tree_map(
        lambda y0, y1, ym, f0, f1: _d(y0) * (5 * f0 - 3 * f1) + 18 * y0 + 14 * y1 - 32 * ym,
        y0, y1, y_mid, f0, f1,
    )
    a = tree_map(
        lambda y0, y1, ym, f0, f1: 2 * _d(y0) * (f1 - f0) - 8 * (y1 + y0) + 16 * ym,
        y0, y1, y_mid, f0, f1,
    )
    return [e, d, c, b, a]


def horner(coefficients, x):
    """Evaluate ``interp_fit`` coefficients at the step fractions ``x``: a
    0-dim ``x`` gives the state's shape, a ``[m]`` one a leading axis of m."""

    def leaf(e, d, c, b, a):
        xx = x.reshape(x.shape + (1,) * e.dim()).to(e.dtype)
        return e + xx * (d + xx * (c + xx * (b + xx * a)))

    return tree_map(leaf, *coefficients)


def interp_evaluate(coefficients, t0, t1, t):
    """Horner evaluation of ``interp_fit`` coefficients at time(s) ``t``.

    The zero-length interval (t0 == t1, before the first accepted step)
    evaluates to ``coefficients[0]``, the state at ``t0``; callers clamp
    ``t`` into ``[t0, t1]``."""
    x = (t - t0) / (t1 - t0)
    x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    return horner(coefficients, x)


def compute_error_ratio(error_estimate, rtol, atol, y0, y1, norm: Callable = rms_norm):
    """``norm(err / (atol + rtol * max(|y0|, |y1|)))`` over the state tree."""
    ratio = tree_map(
        lambda e, a, b: e / (atol + rtol * torch.maximum(torch.abs(a), torch.abs(b))),
        error_estimate, y0, y1,
    )
    return torch.abs(torch.as_tensor(norm(ratio)))


def optimal_step_size(last_step, error_ratio, safety, ifactor, dfactor, order):
    """The step controller, branchless: grow by ``ifactor`` on a zero-error
    step, never shrink an accepted one (dfactor -> 1 when error_ratio < 1),
    else scale by ``clip(safety / error_ratio**(1/order), dfactor, ifactor)``."""
    last_step = torch.as_tensor(last_step)
    dtype, device = last_step.dtype, last_step.device
    if isinstance(error_ratio, torch.Tensor):
        error_ratio = error_ratio.to(dtype)
    else:
        error_ratio = torch.as_tensor(error_ratio, dtype=dtype, device=device)
    one = torch.ones((), dtype=dtype, device=device)
    dfactor = torch.where(error_ratio < 1.0, one, torch.full_like(one, dfactor))
    exponent = torch.reciprocal(torch.full_like(one, order))
    # 0**-x = inf would give nan; the zero branch is selected away below
    safe_ratio = torch.clamp_min(error_ratio, torch.finfo(dtype).tiny)
    factor = torch.minimum(
        torch.full_like(one, ifactor), torch.maximum(safety / safe_ratio**exponent, dfactor)
    )
    return torch.where(error_ratio == 0, last_step * ifactor, last_step * factor)


def select_initial_step(move, t0, y0, order, rtol, atol, norm: Callable = rms_norm, f0=None):
    """Hairer-Norsett-Wanner II.4 initial-step heuristic, branchless.

    ``move(t, dt, y) -> dy`` is the XDE derivative hook. Returns a 0-dim
    tensor of ``t0``'s dtype on ``t0``'s device."""
    t0 = torch.as_tensor(t0)
    t_dtype = t0.dtype
    zero_dt = torch.zeros((), dtype=t_dtype, device=t0.device)
    if f0 is None:
        f0 = move(t0, zero_dt, y0)

    scale = tree_map(lambda y: atol + torch.abs(y) * rtol, y0)
    d0 = torch.abs(norm(tree_map(torch.div, y0, scale)))
    d1 = torch.abs(norm(tree_map(torch.div, f0, scale)))

    leaves = tree_leaves(y0)
    dtype = leaves[0].dtype
    for leaf in leaves[1:]:
        dtype = torch.promote_types(dtype, leaf.dtype)
    tiny = torch.finfo(dtype).tiny
    small = torch.full((), 1e-6, dtype=dtype, device=d0.device)
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), small, 0.01 * d0 / torch.clamp_min(d1, tiny))
    h0 = torch.abs(h0)

    y1 = tree_map(lambda y, f: y + h0.to(y.dtype) * f, y0, f0)
    f1 = move(t0 + h0.to(t_dtype), zero_dt, y1)
    d2 = torch.abs(norm(tree_map(lambda a, b, s: (a - b) / s, f1, f0, scale)) / h0)

    d_max = torch.maximum(d1, d2)
    h1 = torch.where(
        (d1 <= 1e-15) & (d2 <= 1e-15),
        torch.maximum(small, h0 * 1e-3),
        (0.01 / torch.clamp_min(d_max, tiny)) ** (1.0 / float(order + 1)),
    )
    h1 = torch.abs(h1)
    return torch.minimum(100.0 * h0, h1).to(t_dtype)
