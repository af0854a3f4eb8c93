"""Buffered-dense adaptive solve: one integration pass, vectorised output.

Counterpart of ``paddlexde_tpu/solver/adaptive_dense.py``. The solve runs
once over the whole span with the engine's step (``adaptive.py``, one host
read per attempted step); every accepted step's quartic dense-output
coefficients are kept, at most ``max_steps`` of them (more sets
``MAX_STEPS_EXCEEDED`` and the tail clamps), and all requested times are
evaluated at once by one ``torch.searchsorted`` and one Horner pass. The
JAX version keeps a static ring of ``max_steps`` slots; here the buffer
holds the accepted steps only, with the same lookups.

Autograd runs through it as through ``adaptive.py``'s engine (the step
control detached), so the gradient to ``y0``, to the tensors ``func``
closes over and to the output times is the discrete derivative on the
discovered grid; the JAX dense engine has no reverse mode.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils._pytree import tree_map

from ..utils.norms import rms_norm
from ..xde.term import XDETerm
from .adaptive import (
    MAX_STEPS_EXCEEDED,
    TABLEAUS,
    initial_state,
    make_adaptive_step,
    prepare_times,
    stats_of,
    warn_grid_overflow,
)

__all__ = ["solve_adaptive_dense", "DenseSolution"]


class DenseSolution:
    """Callable continuous solution of one buffered-dense adaptive solve.

    ``sol(t)`` evaluates the interpolant at arbitrary times (scalar or 1-D)
    in one vectorised searchsorted + Horner pass; ``sol.derivative(t)`` is
    the quartic's exact time derivative over the covering step. Times
    outside the span clamp to its ends. Autograd flows through evaluation
    (to ``t``) and, unless the solve ran without gradients, to what the
    solve depended on. ``sign`` is -1 for a reversed-time solve: the buffers
    live in ``s = -t`` and queries map through it.
    """

    def __init__(self, t_lo, t_end, buf_t0, buf_t1, buf_coeff, n_steps, y0, sign: float = 1.0):
        self.t_lo = t_lo
        self.t_end = t_end
        self.buf_t0 = buf_t0
        self.buf_t1 = buf_t1
        self.buf_coeff = buf_coeff  # list of 5 trees, leading axis = steps
        self.n_steps = n_steps
        self.y0 = y0
        self.sign = float(sign)

    def _locate(self, t):
        tq = torch.atleast_1d(self.sign * torch.as_tensor(t, dtype=self.buf_t1.dtype,
                                                          device=self.buf_t1.device))
        idx = torch.searchsorted(self.buf_t1.detach(), tq.detach().contiguous(), right=False)
        idx = idx.clamp(0, max(self.n_steps - 1, 0))
        seg_t0 = self.buf_t0[idx]
        seg_t1 = self.buf_t1[idx]
        # clamp queries to the requested span, not to the last step's end;
        # strict comparisons keep d/dt = 1 at an exact boundary query
        hi = torch.minimum(seg_t1, self.t_end)
        t_eval = torch.where(tq < self.t_lo, self.t_lo, torch.where(tq > hi, hi, tq))
        span = seg_t1 - seg_t0
        safe = torch.where(span == 0, torch.ones_like(span), span)
        x = torch.where(span == 0, torch.zeros_like(t_eval), (t_eval - seg_t0) / safe)
        x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
        return tq, idx, x, span

    def _gathered(self, idx):
        return [tree_map(lambda buf: buf[idx], self.buf_coeff[i]) for i in range(5)]

    def __call__(self, t):
        scalar = torch.as_tensor(t).dim() == 0
        tq, idx, x, _ = self._locate(t)
        sol = _horner_rows(self._gathered(idx), x)
        # the exact left end: a correction without gradient, so d/dt at
        # t_lo stays the interpolant's (as .derivative(t_lo))
        at_lo = tq == self.t_lo

        def fix(sl, y0l):
            mask = at_lo.reshape(at_lo.shape + (1,) * (sl.dim() - 1))
            return sl + torch.where(mask, y0l.to(sl.dtype) - sl, torch.zeros_like(sl)).detach()

        sol = tree_map(fix, sol, self.y0)
        return tree_map(lambda sl: sl[0], sol) if scalar else sol

    def derivative(self, t):
        """d/dt of the interpolant (an order-4 approximation of f(t, y(t)))."""
        scalar = torch.as_tensor(t).dim() == 0
        _, idx, x, span = self._locate(t)

        def dhorner(e, d, c, b, a):
            del e
            xx = x.reshape(x.shape + (1,) * (d.dim() - 1)).to(d.dtype)
            sp = span.reshape(span.shape + (1,) * (d.dim() - 1)).to(d.dtype)
            poly = d + xx * (2.0 * c + xx * (3.0 * b + xx * 4.0 * a))
            return self.sign * poly / torch.where(sp == 0, torch.ones_like(sp), sp)

        out = tree_map(dhorner, *self._gathered(idx))
        return tree_map(lambda o: o[0], out) if scalar else out


def _horner_rows(gathered, x):
    """Horner per row: coefficient leaves ``[m, ...]``, fractions ``[m]``."""

    def leaf(e, d, c, b, a):
        xx = x.reshape(x.shape + (1,) * (e.dim() - 1)).to(e.dtype)
        return e + xx * (d + xx * (c + xx * (b + xx * a)))

    return tree_map(leaf, *gathered)


def solve_adaptive_dense(
    term: XDETerm,
    y0,
    t_span,
    *,
    method: str = "dopri5",
    rtol=1e-7,
    atol=1e-9,
    norm: Callable = rms_norm,
    max_steps: int = 512,
    first_step=None,
    safety=0.9,
    ifactor=10.0,
    dfactor=0.2,
    min_step=0.0,
    max_step=float("inf"),
    return_stats: bool = False,
    time_dtype=None,
    newton_iters: int = 6,
    return_dense: bool = False,
    direct_grad: bool = True,
    grid_buffer: int = 512,
    overflow_warn: bool = True,
    _t_host=None,
):
    """Adaptive solve with buffered dense output; returns ``[T, ...]`` (or a
    callable :class:`DenseSolution` with ``return_dense=True``), plus
    :class:`~paddlexde_tpu_torch.solver.adaptive.AdaptiveStats` with
    ``return_stats``. ``direct_grad=False`` runs without autograd;
    ``newton_iters``: the Newton iterations of an implicit stage."""
    tableau = TABLEAUS[method] if isinstance(method, str) else method
    with torch.set_grad_enabled(torch.is_grad_enabled() and direct_grad):
        out, stats = _solve_dense(term, y0, t_span, tableau, rtol, atol, norm, max_steps,
                                  first_step, safety, ifactor, dfactor, min_step, max_step,
                                  time_dtype, return_dense, _t_host, newton_iters)
    if not return_dense:
        warn_grid_overflow(out, stats, grid_buffer, overflow_warn)
    return (out, stats) if return_stats else out


def _solve_dense(term, y0, t_span, tableau, rtol, atol, norm, max_steps, first_step, safety,
                 ifactor, dfactor, min_step, max_step, time_dtype, return_dense, t_host,
                 newton_iters):
    t_dev, t_host = prepare_times(y0, t_span, time_dtype, t_host)
    time_dtype = t_dev.dtype
    t0, t_end, t_end_host = t_dev[0], t_dev[-1], float(t_host[-1])
    state = initial_state(term, tableau, y0, t0, t_end, t_host[0], rtol, atol, norm,
                          first_step, time_dtype)
    step = make_adaptive_step(term, tableau, rtol, atol, norm, safety, ifactor, dfactor,
                              min_step, max_step, newton_iters=newton_iters)

    steps = []  # (t0, t1, coeff) of every accepted step
    while state.t1_host < t_end_host and len(steps) < max_steps and state.status == 0:
        new = step(state)
        if new.t1_host > state.t1_host:
            steps.append((new.t0, new.t1, new.interp_coeff))
        state = new
    status = state.status
    if state.t1_host < t_end_host and len(steps) >= max_steps:
        status |= MAX_STEPS_EXCEEDED
    stats = stats_of(state, status)

    n_steps = len(steps)
    if n_steps:
        buf_t0 = torch.stack([s[0] for s in steps])
        buf_t1 = torch.stack([s[1] for s in steps])
        buf_coeff = [tree_map(lambda *cs: torch.stack(cs), *[s[2][i] for s in steps])
                     for i in range(5)]
    else:  # no accepted step: one zero slot, as the JAX buffer's first
        inf = torch.full((1,), float("inf"), dtype=time_dtype, device=t_dev.device)
        buf_t0, buf_t1 = inf, inf
        buf_coeff = [tree_map(lambda l: torch.zeros((1,) + l.shape, dtype=l.dtype,
                                                    device=l.device), y0) for _ in range(5)]

    if return_dense:
        return DenseSolution(t0, t_end, buf_t0, buf_t1, buf_coeff, n_steps, y0), stats

    idx = torch.searchsorted(buf_t1.detach(), t_dev.detach().contiguous(), right=False)
    idx = idx.clamp(0, max(n_steps - 1, 0))
    seg_t0, seg_t1 = buf_t0[idx], buf_t1[idx]
    t_eval = torch.minimum(torch.maximum(t_dev, t0), seg_t1)
    span = seg_t1 - seg_t0
    safe = torch.where(span == 0, torch.ones_like(span), span)
    x = torch.where(span == 0, torch.zeros_like(t_eval), (t_eval - seg_t0) / safe)
    x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    sol = _horner_rows([tree_map(lambda buf: buf[idx], buf_coeff[i]) for i in range(5)], x)
    # the first output time is y0 by definition
    sol = tree_map(lambda sl, y0l: torch.cat([y0l[None].to(sl.dtype), sl[1:]]), sol, y0)
    return sol, stats
