"""odeint_event: integrate until an event function crosses zero.

Counterpart of ``paddlexde_tpu/functional/odeint_event.py``. The adaptive
engine steps until an accepted step brackets a sign change of
``event_fn(t, y)`` (or reaches ``t_max`` or the step budget); the event time
is then found by bisection on the quartic dense output of the bracketing
step, with no further field evaluation.

The engine's one device-to-host read per attempted step also carries the
event function's value at the step's end (``make_adaptive_step``'s
``watch``), so the sign test costs no extra transfer; the bisection's
``bisect_iters`` iterations run on the device with no host read. Before the
loop, the sign of ``event_fn(t0, y0)`` is read once.

:func:`odeint_event_grad` gives event-time and event-state gradients by the
implicit-function rule, as the JAX package does.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch
from torch.utils._pytree import tree_leaves, tree_map

from .._device import input_device, place
from ..solver.adaptive import (
    MAX_STEPS_EXCEEDED,
    TABLEAUS,
    RKState,
    host_values,
    make_adaptive_step,
    np_dtype,
)
from ..solver.registry import resolve_solver
from ..utils.norms import rms_norm
from ..utils.ode_utils import interp_evaluate, select_initial_step
from ..xde.term import ode_term
from .odeint import odeint

__all__ = ["odeint_event", "odeint_event_grad", "EventResult"]


class EventResult(NamedTuple):
    """``t_event`` (``t_max`` when no event fired) and ``y_event`` on the
    device; ``event_fired`` (bool) and the solver ``status`` bits on the
    host."""

    t_event: torch.Tensor
    y_event: Any
    event_fired: bool
    status: int


def _host_time(t0, dtype):
    if isinstance(t0, torch.Tensor):
        if t0.device.type == "cpu":
            return float(t0.detach())
        return float(host_values(t0.reshape(1))[0])
    return float(dtype(t0))


def _on_device(t, dtype, device):
    if isinstance(t, torch.Tensor):
        return t.to(device=device, dtype=dtype)
    return torch.full((), float(t), dtype=dtype, device=device)


def odeint_event(
    func: Callable,
    y0,
    t0,
    event_fn: Callable,
    solver="dopri5",
    *,
    t_max=None,
    rtol=1e-7,
    atol=1e-9,
    norm=rms_norm,
    max_num_steps: int = 10_000,
    bisect_iters: int = 50,
    first_step=None,
) -> EventResult:
    """Integrate ``dy/dt = func(t, y)`` from ``(t0, y0)`` until ``event_fn(t,
    y)`` (a scalar) first changes sign from its value at ``t0``.

    ``solver``: an adaptive solver (its dense output brackets the root).
    ``t0`` as a tensor sets the time dtype (at least float32); as a number
    it takes the state's.
    ``t_max``: the horizon (default ``t0 + 1e10``: until the event or the
    step budget). ``bisect_iters``: bisection steps on the dense output (50
    reach float64's resolution)."""
    spec = resolve_solver(solver)
    if spec.kind != "adaptive":
        raise ValueError("odeint_event requires an adaptive solver (e.g. 'dopri5')")
    tableau = TABLEAUS[spec.name]
    term = ode_term(func)
    device = input_device(*tree_leaves(y0))
    y0 = tree_map(lambda a: place(a, device), y0)

    # a tensor t0 sets the time dtype, a number takes the state's
    time_dtype = torch.promote_types(
        t0.dtype if isinstance(t0, torch.Tensor) else tree_leaves(y0)[0].dtype, torch.float32)
    ndt = np_dtype(time_dtype)
    t0_host = ndt(_host_time(t0, ndt))
    t0_d = _on_device(t0, time_dtype, device)
    if t_max is not None:
        t_end_host = ndt(_host_time(t_max, ndt))
        t_end = _on_device(t_max, time_dtype, device)
    else:
        t_end_host = ndt(t0_host + ndt(1e10))
        t_end = t0_d + torch.full((), 1e10, dtype=time_dtype, device=device)

    def event_value(t, y):
        return torch.as_tensor(event_fn(t, y)).to(time_dtype)

    f0 = term.move(t0_d, t_end - t0_d, y0)
    if first_step is None:
        dt0 = select_initial_step(term.move, t0_d.detach(), tree_map(torch.detach, y0),
                                  tableau.order - 1, rtol, atol, norm=norm,
                                  f0=tree_map(torch.detach, f0))
    else:
        dt0 = torch.as_tensor(first_step, dtype=time_dtype, device=device)
    step = make_adaptive_step(term, tableau, rtol, atol, norm, 0.9, 10.0, 0.2, 0.0,
                              float("inf"), watch=event_value)
    zero_coeff = [y0] + [tree_map(torch.zeros_like, y0)] * 4
    state = RKState(y1=y0, f1=f0, t0=t0_d, t1=t0_d, dt=dt0.detach().to(time_dtype),
                    interp_coeff=zero_coeff, next_step_index=0, next_jump_index=0, nfe=1,
                    n_accept=0, n_reject=0, status=0, t1_host=float(t0_host))
    value0 = event_value(t0_d, y0)
    sign0 = float(np.sign(host_values(value0.reshape(1))[0]))

    def crossed(s, t0_host_s):
        return s.watch is not None and np.sign(s.watch) != sign0 and s.t1_host > t0_host_s

    n, start_host, fired = 0, float(t0_host), False
    while not fired and state.t1_host < t_end_host and n < max_num_steps and state.status == 0:
        start_host = state.t1_host  # the attempted step's start (the state's new t0)
        state = step(state)
        n += 1
        fired = crossed(state, start_host)
    status = state.status
    if not fired and state.t1_host < t_end_host and n >= max_num_steps:
        status |= MAX_STEPS_EXCEEDED

    # bisection for the crossing on the bracketing step's dense output
    coeff, lo, hi = state.interp_coeff, state.t0.detach(), state.t1.detach()
    sign0_d = torch.sign(value0.detach())
    with torch.no_grad():
        for _ in range(bisect_iters):
            mid = 0.5 * (lo + hi)
            same = torch.sign(event_value(mid, interp_evaluate(coeff, state.t0, state.t1, mid))
                              ) == sign0_d
            lo = torch.where(same, mid, lo)
            hi = torch.where(same, hi, mid)
    t_event = hi if fired else torch.minimum(state.t1.detach(), t_end)
    y_event = interp_evaluate(coeff, state.t0, state.t1, t_event)
    return EventResult(t_event=t_event, y_event=y_event, event_fired=fired, status=status)


class _ImplicitEventTime(torch.autograd.Function):
    """``t* - g / denom`` with ``denom = dg/dt`` along the trajectory held
    constant: the value is the searched root corrected by one Newton step
    (``g`` ~ 0 there), the gradient is the implicit-function rule ``dt*/dθ
    = -(dg/dθ) / (dg/dt)``, carried by ``g = event_fn(t*, y(t*; θ))``."""

    @staticmethod
    def forward(ctx, t_star, g_val, denom):
        ctx.save_for_backward(denom)
        return t_star - g_val / denom

    @staticmethod
    def backward(ctx, grad):
        (denom,) = ctx.saved_tensors
        return None, -grad / denom, None


def odeint_event_grad(
    func: Callable,
    y0,
    t0,
    event_fn: Callable,
    solver="dopri5",
    *,
    rtol=1e-9,
    atol=1e-11,
    **event_kwargs,
) -> EventResult:
    """Differentiable event location.

    The event time satisfies ``g(t*, y(t*; θ)) = 0``, so ``dt*/dθ = -(dg/dy
    dy/dθ + dg/dθ) / (dg/dt + dg/dy f)``. The search (:func:`odeint_event`)
    runs without gradients; the state at the found time comes from a
    differentiable ``odeint`` over ``[t0, t*]`` (autograd through the
    port's adaptive solve, exact on its grid: the JAX package takes
    ``odeint_adjoint`` there, as it cannot differentiate its loop), and
    :class:`_ImplicitEventTime` turns ``g`` at that state into the event
    time's gradient. ``y_event = y(t*) + f (t_event - t*)`` with ``f``
    held constant, so ``dy_event/dθ = dy/dθ + f dt*/dθ``. Gradients reach
    ``y0`` and the tensors ``func`` and ``event_fn`` close over."""
    with torch.no_grad():
        res = odeint_event(func, tree_map(torch.detach, y0), t0, event_fn, solver, rtol=rtol,
                           atol=atol, **event_kwargs)
    t_star = res.t_event.detach()
    t0_d = _on_device(t0, t_star.dtype, t_star.device)
    y_at = tree_map(lambda a: a[1], odeint(func, y0, torch.stack([t0_d, t_star]), solver,
                                           rtol=rtol, atol=atol, time_axis=0))
    g_val = torch.as_tensor(event_fn(t_star, y_at)).to(t_star.dtype)
    f_at = func(t_star, y_at)
    y_fixed = tree_map(torch.detach, y_at)
    f_fixed = tree_map(torch.detach, f_at)
    def d_dt(g_of):
        # the derivative at t*, 0 where g does not depend on its argument
        with torch.enable_grad():
            leaf = t_star.clone().requires_grad_(True)
            out = torch.as_tensor(g_of(leaf))
            if not out.requires_grad:
                return torch.zeros_like(t_star)
            return torch.autograd.grad(out, leaf)[0].to(t_star.dtype)

    denom = d_dt(lambda t: event_fn(t, y_fixed)) + d_dt(lambda s: event_fn(
        t_star, tree_map(lambda ya, fa: ya + (s - t_star) * fa, y_fixed, f_fixed)))
    denom = torch.where(torch.abs(denom) < 1e-30, torch.ones_like(denom), denom).detach()
    t_event = _ImplicitEventTime.apply(t_star, g_val, denom)
    y_event = tree_map(lambda ya, fa: ya + fa * (t_event - t_star).to(ya.dtype), y_at, f_fixed)
    return EventResult(t_event=t_event, y_event=y_event, event_fired=res.event_fired,
                       status=res.status)
