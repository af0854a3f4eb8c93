"""Dispatch from the functional API into the solver engines.

Counterpart of ``paddlexde_tpu/functional/solve.py``: solver resolution and
``options`` validation (the JAX package's whole option vocabulary is known,
so a typo raises ``ValueError``), reverse-time canonicalisation (a
decreasing span is integrated in ``s = -t`` with a negated field, and the
time-valued options follow), the dispatch into the fixed-grid engine, the
adaptive engine or, with ``options["max_steps"]``, the buffered-dense
adaptive engine (``solve.py:221-262``), the Adams engine and the SciPy
bridge (``solve.py:263-276``), and the output layout (time moved from axis
0 to ``time_axis``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils._pytree import tree_leaves, tree_map

from .._device import input_device, place
from ..solver.adams import solve_adams
from ..solver.adaptive import host_times, solve_adaptive
from ..solver.adaptive_dense import solve_adaptive_dense
from ..solver.fixed import solve_fixed
from ..solver.scipy_wrapper import solve_scipy
from ..solver.registry import SolverSpec, require_ported, resolve_solver
from ..utils.misc import host_array
from ..utils.norms import rms_norm
from ..xde.term import XDETerm

__all__ = ["integrate_term", "format_solution"]

_FIXED_KEYS = {"interp", "step_size", "grid_constructor", "grid", "time_dtype", "checkpoint"}
_ADAPTIVE_KEYS = {
    "max_steps", "norm", "first_step", "safety", "ifactor", "dfactor",
    "min_step", "max_step", "max_num_steps", "step_t", "jump_t",
    "return_stats", "time_dtype", "newton_iters", "direct_grad",
    "grid_buffer", "overflow_warn",
}
_ADAMS_KEYS = {"implicit", "max_iters", "max_order", "step_size", "grid_constructor",
               "grid", "time_dtype", "norm"}


def _is_decreasing(t_span: torch.Tensor) -> bool:
    """One host read of the two ends (a device-to-host sync only when the
    caller put ``t_span`` on the card)."""
    if t_span.numel() < 2:
        return False
    first, last = host_array(t_span[[0, -1]]).tolist()
    return last < first


def _reversed_term(term: XDETerm) -> XDETerm:
    """Time substitution t = -s: dy/ds = -move(-s, ., y)."""

    def move(s, ds, y):
        return tree_map(torch.negative, term.move(-s, -ds, y))

    return XDETerm(move=move, fuse=term.fuse, additive=term.additive, kind=term.kind)


def _negate_time_options(options: dict) -> dict:
    """Options that name points in the original time follow t = -s
    (durations -- step_size, first_step, min/max_step -- do not)."""
    options = dict(options)
    for key in ("grid", "step_t", "jump_t"):
        if options.get(key) is not None:
            options[key] = -torch.as_tensor(options[key])
    gc = options.get("grid_constructor")
    if gc is not None:
        options["grid_constructor"] = lambda ts: -torch.as_tensor(gc(-ts))
    return options


def _canonicalize_direction(term, t_span, options):
    if _is_decreasing(t_span):
        return _reversed_term(term), -t_span, _negate_time_options(options)
    return term, t_span, options


def format_solution(solution, time_axis: int = -2):
    """Move the leading time axis of every leaf to ``time_axis`` (default -2)."""
    if time_axis == 0:
        return solution

    def leaf(arr):
        if arr.dim() <= 1:
            return arr
        return torch.movedim(arr, 0, time_axis if time_axis >= 0 else arr.dim() + time_axis)

    return tree_map(leaf, solution)


def _solve(term, y0, t_span, method, options, time_axis, kind="fixed", rtol=None, atol=None,
           implicit=False):
    # time stays where the caller put it: numpy/list times become host
    # tensors (the grid is read on the host; a 0-dim host time mixes freely
    # with device states); the state goes to the device of its first tensor
    # leaf, else to the card
    t_span = torch.as_tensor(t_span)
    device = input_device(*tree_leaves(y0))
    y0 = tree_map(lambda a: place(a, device), y0)
    term, t_span, options = _canonicalize_direction(term, t_span, options)
    if kind == "adams":
        kw = {k: v for k, v in options.items() if k in _ADAMS_KEYS}
        implicit = implicit or kw.pop("implicit", False)
        sol = solve_adams(term, y0, t_span, rtol=rtol, atol=atol, implicit=implicit, **kw)
    elif kind == "scipy":
        kw = {k: v for k, v in options.items() if k == "scipy_method"}
        sol = solve_scipy(term, y0, t_span, rtol=rtol, atol=atol, **kw)
    else:
        kw = {k: v for k, v in options.items() if k in _FIXED_KEYS}
        sol = solve_fixed(term, y0, t_span, method=method, **kw)
    return format_solution(sol, time_axis)


def _solve_adaptive(term, y0, t_span, method, options, time_axis, rtol, atol):
    """The adaptive dispatch: the span's values are read to the host once
    (none when it lies on the CPU) and serve both the direction and the
    engine's loop."""
    t_span = torch.as_tensor(t_span)
    device = input_device(*tree_leaves(y0))
    y0 = tree_map(lambda a: place(a, device), y0)
    t_host = host_times(t_span)
    if t_host.size >= 2 and t_host[-1] < t_host[0]:
        term, t_span, t_host = _reversed_term(term), -t_span, -t_host
        options = _negate_time_options(options)
    if "max_steps" in options:
        # buffered-dense engine: one integration pass + vectorised output
        keys = _ADAPTIVE_KEYS - {"step_t", "jump_t", "max_num_steps"}
        engine = solve_adaptive_dense
    else:
        keys = _ADAPTIVE_KEYS - {"max_steps"}
        engine = solve_adaptive
    kw = {k: v for k, v in options.items() if k in keys}
    out = engine(term, y0, t_span, method=method, rtol=rtol, atol=atol, _t_host=t_host, **kw)
    if options.get("return_stats"):
        sol, stats = out
        return format_solution(sol, time_axis), stats
    return format_solution(out, time_axis)


def integrate_term(
    term: XDETerm,
    y0,
    t_span,
    solver,
    *,
    rtol=1e-7,
    atol=1e-9,
    options: Optional[dict] = None,
    time_axis: int = -2,
    interp: Optional[str] = None,
):
    """Dispatch one integration; returns the formatted solution (with
    :class:`~paddlexde_tpu_torch.solver.adaptive.AdaptiveStats` when an
    adaptive solver runs with ``options["return_stats"]``).

    ``solver`` is a name, a :class:`SolverSpec`, or a custom fixed-step
    function ``step(term, t0, t1, y0) -> (y1, dy0)``. ``rtol``/``atol`` are
    read by the adaptive solvers only.
    """
    if callable(solver) and not isinstance(solver, SolverSpec):
        options = dict(options or {})
        unknown = set(options) - _FIXED_KEYS - {"norm"}
        if unknown:
            raise ValueError(
                f"custom step functions take fixed-solver options only; "
                f"unknown: {sorted(unknown)}"
            )
        return _solve(term, y0, t_span, solver, options, time_axis)

    spec = resolve_solver(solver)
    options = dict(options or {})
    if interp is not None:
        options.setdefault("interp", interp)
    options.setdefault("norm", rms_norm)

    known = _FIXED_KEYS | _ADAPTIVE_KEYS | _ADAMS_KEYS | {"scipy_method", "norm"}
    unknown = set(options) - known
    if unknown:
        raise ValueError(
            f"unknown solver option(s) {sorted(unknown)}; known options: {sorted(known)}"
        )
    require_ported(spec)
    if spec.kind == "adaptive":
        return _solve_adaptive(term, y0, t_span, spec.name, options, time_axis, rtol, atol)
    return _solve(term, y0, t_span, spec.name, options, time_axis, spec.kind, rtol, atol,
                  implicit=spec.name == "implicit_adams")
