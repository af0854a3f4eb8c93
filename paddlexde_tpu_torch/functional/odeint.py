"""odeint: solve dy/dt = func(t, y), y(t0) = y0.

Counterpart of ``paddlexde_tpu/functional/odeint.py`` (``odeint``,
``odeint_dense``), with the reference's signature
(``paddlexde/functional/odeint.py:9-35``). ``y0`` may be a tensor or a
nested tuple/list/dict of tensors; the solution has time on axis -2 of
every leaf (``time_axis=0`` for time-first).

Where it runs: where ``y0`` lies (CPU tensors run on the CPU, as the tests
do); numpy or list data goes to the card, and with no card that raises.
``t_span`` may lie on the card or the host: its values are read to the host
once. ``odeint_per_element`` steps every batch element with its own
adaptive control.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils._pytree import tree_leaves, tree_map

from .._device import input_device, place
from ..solver.adaptive import host_times
from ..solver.adaptive_dense import DenseSolution, solve_adaptive_dense
from ..solver.per_element import solve_adaptive_per_element
from ..solver.registry import require_ported, resolve_solver
from ..utils.norms import rms_norm
from ..xde.term import ode_term
from .solve import integrate_term

__all__ = ["odeint", "odeint_dense", "odeint_per_element"]


def odeint(
    func,
    y0,
    t_span,
    solver="dopri5",
    *,
    rtol=1e-7,
    atol=1e-9,
    options: Optional[dict] = None,
    time_axis: int = -2,
):
    """Integrate an ODE system.

    Args:
        func: vector field ``func(t, y) -> dy/dt`` (tree-valued).
        y0: initial state (tensor or tree of tensors).
        t_span: 1-D output times (monotonic; a decreasing span is integrated
            in reversed time).
        solver: a solver marker (``Euler``/``RK4``/``Dopri5``/...) or name.
        rtol, atol: adaptive error tolerances.
        options: solver options (``norm``, ``step_size``, ``interp``,
            ``first_step``, ``safety``, ``ifactor``, ``dfactor``, ``step_t``,
            ``jump_t``, ``min_step``, ``max_step``, ``max_num_steps``,
            ``max_steps`` (the buffered-dense engine), ``return_stats``,
            ``direct_grad``, ``grid_buffer``, ``overflow_warn``,
            ``checkpoint`` for the fixed-grid solvers).
        time_axis: where to place the time axis in each output leaf.

    Returns:
        The solution with a ``len(t_span)`` time axis per leaf (plus
        :class:`~paddlexde_tpu_torch.solver.adaptive.AdaptiveStats` when
        ``options={"return_stats": True}`` on an adaptive solver).
        Autograd runs through the solve (adaptive: the discrete derivative
        on the discovered grid); :func:`odeint_adjoint` gives O(1)-memory
        gradients.
    """
    return integrate_term(ode_term(func), y0, t_span, solver, rtol=rtol, atol=atol,
                          options=options, time_axis=time_axis)


def odeint_dense(
    func,
    y0,
    t_span,
    solver="dopri5",
    *,
    rtol=1e-7,
    atol=1e-9,
    options: Optional[dict] = None,
):
    """Integrate once and return a callable
    :class:`~paddlexde_tpu_torch.solver.adaptive_dense.DenseSolution`.

    One buffered-dense adaptive pass over ``[t_span[0], t_span[-1]]`` keeps
    every accepted step's quartic dense output; the result evaluates the
    interpolant (``sol(t)``) and its time derivative (``sol.derivative(t)``)
    at any times. A decreasing span solves the reversed system over s = -t
    and the returned object maps queries through it.

    Args:
        func, y0, rtol, atol: as :func:`odeint`.
        t_span: only the end points matter.
        solver: an adaptive solver name or marker.
        options: ``max_steps`` (default 512), ``first_step``, ``safety``,
            ``ifactor``, ``dfactor``, ``min_step``, ``max_step``, ``norm``,
            ``return_stats``, ``time_dtype``.

    Returns:
        ``DenseSolution``, or ``(DenseSolution, AdaptiveStats)`` with
        ``options={"return_stats": True}``.
    """
    spec = resolve_solver(solver)
    if spec.kind != "adaptive":
        raise ValueError(
            f"odeint_dense needs an adaptive solver (got {spec.name!r}); "
            "fixed-step solutions are already dense on their own grid"
        )
    require_ported(spec)
    opts = dict(options or {})
    allowed = {"max_steps", "first_step", "safety", "ifactor", "dfactor", "min_step",
               "max_step", "norm", "return_stats", "time_dtype"}
    unknown = set(opts) - allowed
    if unknown:
        raise ValueError(
            f"odeint_dense got unknown option(s) {sorted(unknown)}; known: {sorted(allowed)}"
        )
    t_span = torch.as_tensor(t_span)
    device = input_device(*tree_leaves(y0))
    y0 = tree_map(lambda a: place(a, device), y0)
    t_host = host_times(t_span)
    sign = 1.0
    if t_host[-1] <= t_host[0]:
        if t_host[-1] == t_host[0]:
            raise ValueError("odeint_dense needs a non-degenerate span")
        # reversed time: solve y(-s) on the increasing -t_span; the
        # DenseSolution maps queries (and d/dt) through s = -t
        sign = -1.0
        inner = func

        def func(s, y):
            return tree_map(torch.negative, inner(-s, y))

        t_span, t_host = -t_span, -t_host
    out = solve_adaptive_dense(ode_term(func), y0, t_span, method=spec.name, rtol=rtol,
                               atol=atol, return_dense=True, _t_host=t_host, **opts)
    if sign == 1.0:
        return out
    dense, stats = out if isinstance(out, tuple) else (out, None)
    dense = DenseSolution(dense.t_lo, dense.t_end, dense.buf_t0, dense.buf_t1, dense.buf_coeff,
                          dense.n_steps, dense.y0, sign=sign)
    return (dense, stats) if stats is not None else dense


_PER_ELEMENT_KEYS = {"return_stats", "first_step", "safety", "ifactor", "dfactor", "min_step",
                     "max_step", "max_num_steps", "norm", "time_dtype"}


def _per_element_layout(solution, time_axis):
    """``[T, B, ...]`` -> the batch first and, in each element, time at
    ``time_axis`` (the layout of ``jax.vmap`` over ``odeint``)."""

    def leaf(arr):
        arr = torch.movedim(arr, 1, 0)
        elem_dim = arr.dim() - 1
        if elem_dim <= 1:
            return arr
        axis = time_axis if time_axis >= 0 else elem_dim + time_axis
        return torch.movedim(arr, 1, 1 + axis)

    return tree_map(leaf, solution)


def odeint_per_element(func, y0, t_span, solver="dopri5", *, rtol=1e-7, atol=1e-9,
                       options: Optional[dict] = None, time_axis: int = -2):
    """``odeint`` with independent adaptive step control per batch element.

    ``odeint`` on a batched state shares one error norm, so the stiffest
    element sets every element's step. Here each element of the leading
    axis of every leaf steps at its own pace (the JAX package ``jax.vmap``s
    the whole solve; :mod:`~paddlexde_tpu_torch.solver.per_element` is the
    batched controller that does it here, with one device-to-host read per
    attempted step). ``func`` is called under ``torch.func.vmap``: it sees a
    scalar ``t`` and one element's state, and must not read values on the
    host. The explicit adaptive solvers take ``options`` ``first_step``,
    ``safety``, ``ifactor``, ``dfactor``, ``min_step``, ``max_step``,
    ``max_num_steps``, ``norm``, ``time_dtype`` and ``return_stats`` (then
    the stats are ``[B]`` tensors: ``stats.nfe`` shows the spread). An
    explicit fixed-grid solver runs on the shared grid with the field
    vmapped. The implicit, Adams and SciPy solvers are refused (use
    ``odeint``).

    Returns the solution with the batch first and each element laid out as
    ``odeint`` lays out one element's solution (time at ``time_axis``)."""
    spec = resolve_solver(solver)
    require_ported(spec)
    opts = dict(options or {})
    device = input_device(*tree_leaves(y0))
    y0 = tree_map(lambda a: place(a, device), y0)
    t_span = torch.as_tensor(t_span)
    batched = torch.func.vmap(func, in_dims=(None, 0))
    if spec.kind == "fixed" and not spec.implicit:
        sol = integrate_term(ode_term(batched), y0, t_span, spec, options=opts, time_axis=0)
        return _per_element_layout(sol, time_axis)
    if spec.kind != "adaptive" or spec.implicit:
        raise ValueError(
            f"odeint_per_element runs the explicit adaptive and fixed-grid solvers, not "
            f"{spec.name!r} ({spec.kind}{', implicit' if spec.implicit else ''}); use odeint")
    unknown = set(opts) - _PER_ELEMENT_KEYS
    if unknown:
        raise ValueError(f"odeint_per_element got unknown option(s) {sorted(unknown)}; known: "
                         f"{sorted(_PER_ELEMENT_KEYS)}")
    return_stats = opts.pop("return_stats", False)
    opts.setdefault("norm", rms_norm)
    t_host = host_times(t_span)
    term = ode_term(func)
    if t_host.size >= 2 and t_host[-1] < t_host[0]:
        inner = func

        def reversed_func(s, y):
            return tree_map(torch.negative, inner(-s, y))

        term, t_span, t_host = ode_term(reversed_func), -t_span, -t_host
    sol, stats = solve_adaptive_per_element(term, y0, t_span, method=spec.name, rtol=rtol,
                                            atol=atol, _t_host=t_host, **opts)
    sol = _per_element_layout(sol, time_axis)
    return (sol, stats) if return_stats else sol
