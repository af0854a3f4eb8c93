"""Adaptive embedded Runge-Kutta engine.

Counterpart of ``paddlexde_tpu/solver/adaptive.py`` (``make_rk_core`` :124,
``make_adaptive_step`` :229, ``solve_adaptive`` :338). The JAX package runs
the solve as one ``lax.while_loop`` per output time inside a ``lax.scan``;
PyTorch runs eagerly, so here the loop is a host loop over device tensors:

- every attempted step is the JAX step's arithmetic on the card (stages,
  anchored error estimate, error ratio, accept decision, next ``dt``, the
  status bits as selects), followed by **one** device-to-host read that
  brings back the accept flag, the status bits, the ``step_t``/``jump_t``
  landing flags and the step's end time together (``HOST_READS["step"]``
  counts these reads). Nothing inside the stages or the error norm reads
  the card;
- the host then keeps or drops the step (the JAX version's selects on the
  state become a Python branch on the value it has just read), so a
  rejected step leaves nothing in an autograd graph;
- the counters ``nfe``/``n_accept``/``n_reject`` and ``status`` are host
  integers (:class:`AdaptiveStats`); the flags are the JAX package's.

The stage buffer keeps the stages on a leading axis (``[S, ...state]`` per
leaf) and every combination is one weighted sum over it; the error estimate
is the anchored ``dt * sum_i e_i (k_i - k_0)`` of the JAX engine
(``_error_combine``, :93-121). Output times are evaluated from the quartic
dense output of the step that covers them, all outputs of one step in one
vectorised Horner pass.

Direct gradients (counterpart of ``solver/adaptive_autodiff.py``): autograd
runs through this loop. The step control is detached -- ``dt``, the accept
decision and the accepted step ends carry no gradient -- so the gradient to
``y0``, to the tensors ``func`` closes over and to ``t_span`` is the exact
discrete derivative of the arithmetic on the discovered grid, as the JAX
package's replay computes it: the only differentiable grid point is the
start ``t_span[0]`` (its step's ``dt = t1 - t0`` and stage times follow it),
and output times reach the dense-output evaluation. Deliberate difference
to JAX: past ``grid_buffer`` accepted steps the JAX replay merges the tail
into one coarse step; here the gradient stays exact (autograd holds every
step) and the same ``RuntimeWarning`` is raised when a differentiated solve
accepts more than ``grid_buffer`` steps (``overflow_warn=False`` silences
it). ``direct_grad=False`` runs the engine under ``torch.no_grad``.

The implicit tableaus (kvaerno3, sdirk4, trbdf2) solve their diagonal
stages by dense Newton iterations (``make_rk_core``; ``implicit.py``), in
this engine, the buffered-dense one and ``odeint_adjoint``'s backward.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_leaves, tree_map, tree_unflatten

from ..utils.misc import host_array
from ..utils.norms import rms_norm
from ..utils.ode_utils import (
    compute_error_ratio,
    interp_evaluate,
    interp_fit,
    optimal_step_size,
    select_initial_step,
)
from ..xde.term import XDETerm
from .implicit import ravel, stage_newton_solve
from .tableaus import TABLEAUS, ButcherTableau

__all__ = ["solve_adaptive", "AdaptiveStats", "RKState", "make_rk_core", "make_adaptive_step",
           "HOST_READS", "reset_host_reads", "OK", "DT_UNDERFLOW", "NON_FINITE",
           "MAX_STEPS_EXCEEDED"]

# status bit flags (the JAX package's values)
OK = 0
DT_UNDERFLOW = 1
NON_FINITE = 2
MAX_STEPS_EXCEEDED = 4

# device-to-host reads of the adaptive engines: "step" one per attempted
# step, "setup" the reads of times before a loop (a t_span on the card)
HOST_READS: Dict[str, int] = {"step": 0, "setup": 0}


def reset_host_reads() -> None:
    for key in HOST_READS:
        HOST_READS[key] = 0


def host_values(x: torch.Tensor, kind: str = "setup"):
    """``x`` as host values (a list), counted in ``HOST_READS[kind]``."""
    HOST_READS[kind] += 1
    return host_array(x).tolist()


def np_dtype(dtype: torch.dtype):
    return np.float32 if dtype == torch.float32 else np.float64


def time_dtype_of(t_span: torch.Tensor, time_dtype=None) -> torch.dtype:
    """The JAX package's ``result_type(t_span.dtype, float32)``."""
    if time_dtype is not None:
        return time_dtype
    return torch.promote_types(t_span.dtype, torch.float32)


class AdaptiveStats(NamedTuple):
    """Host integers: vector-field evaluations, accepted and rejected steps,
    and the status bits (0 = OK)."""

    nfe: int
    n_accept: int
    n_reject: int
    status: int


class RKState(NamedTuple):
    """The loop state (the JAX engine's ``RKState`` carry). ``y1``/``f1``
    are trees on the device, ``t0``/``t1``/``dt`` 0-dim device tensors;
    ``t1_host`` is ``t1``'s value on the host, the rest host integers."""

    y1: Any
    f1: Any
    t0: torch.Tensor
    t1: torch.Tensor
    dt: torch.Tensor
    interp_coeff: Any  # 5-list of state trees (quartic dense output)
    next_step_index: int
    next_jump_index: int
    nfe: int
    n_accept: int
    n_reject: int
    status: int
    t1_host: float
    watch: Optional[float] = None  # ``watch(t1, y1)`` read with the step


class _Coefficients:
    """A tableau's weights as tensors, once per (dtype, device)."""

    # one copy per (tableau, dtype, device) for the process: a solve makes no
    # host-to-device copy of its weights after the first
    _cache: Dict[Any, Dict[str, torch.Tensor]] = {}

    def __init__(self, tableau: ButcherTableau):
        self.tableau = tableau

    def __call__(self, dtype, device):
        # keyed by the tableau object (each entry keeps it alive, so its id
        # stays its own)
        key = (id(self.tableau), dtype, device)
        if key not in self._cache:
            tab = self.tableau

            def as_t(a):
                return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype, device=device)

            self._cache[key] = {"beta": as_t(tab.beta), "c_sol": as_t(tab.c_sol),
                                "c_error": as_t(tab.c_error), "c_mid": as_t(tab.c_mid),
                                "tableau": tab}
        return self._cache[key]


def _weighted(coef, stack):
    """``sum_i coef[i] * stack[i]`` over the leading (stage) axis. On the CPU
    the contraction of the JAX engine (``tensordot``, the same rounding as
    XLA's CPU dot); on the card a product and a sum, so that no TF32 setting
    of the matmul can reach the error estimate."""
    if stack.is_cuda:
        return (coef.reshape(coef.shape + (1,) * (stack.dim() - 1)) * stack).sum(0)
    return torch.tensordot(coef, stack, dims=([0], [0]))


def make_rk_core(term: XDETerm, tableau: ButcherTableau, newton_iters: int = 6):
    """The single-step math of the engine: ``runge_kutta_step(y0, f0, t0,
    dt, t1) -> (y1, f1, y1_error, k)`` with ``k`` a tree of ``[S, ...]``
    stage stacks, and ``interp_fit_step(y0, y1, k, dt, f0) -> coeff``.

    An implicit ((E)SDIRK) tableau solves each diagonal stage ``Y_i = y0 +
    dt (beta_i . k) + dt g_i f(t_i, Y_i)`` by ``newton_iters`` dense Newton
    iterations (``implicit.stage_newton_solve``) and recovers the stage
    derivative from the solved equation, ``f_i = (Y_i - base_i) / (g_i
    dt)``, with no extra field call. An explicit first stage (ESDIRK) reuses
    the step-entry derivative ``f0``; an implicit one (sdirk4) solves
    ``Y_0 = y0 + g_0 dt f(t0 + g_0 dt, Y_0)`` first."""
    n_stages = tableau.n_stages
    weights = _Coefficients(tableau)

    def base_of(y0_l, ks, i, dt_):
        out = []
        for j, y in enumerate(y0_l):
            w = weights(y.dtype, y.device)["beta"][i, : i + 1]
            stack = torch.stack([k[j] for k in ks])
            out.append(y + _weighted(w, stack) * dt_.to(y.dtype))
        return out

    def explicit_stages(y0_, f0_, t0_, dt_, t1_):
        y0_l, spec = tree_flatten(y0_)
        ks = [tree_leaves(f0_)]
        yi_l = y0_l
        for i in range(n_stages - 1):
            alpha_i = float(tableau.alpha[i])
            ti = t1_ if alpha_i == 1.0 else t0_ + alpha_i * dt_
            yi_l = base_of(y0_l, ks, i, dt_)
            ks.append(tree_leaves(term.move(ti, dt_, tree_unflatten(yi_l, spec))))
        return ks, yi_l

    def stage_solve(ti, dt_, base, gamma):
        base_flat, unravel = ravel(base)
        gdt = dt_.to(base_flat.dtype) * gamma  # gamma rounded to the state's dtype

        def f_at(y_flat):
            return ravel(term.move(ti, dt_, unravel(y_flat)))[0]

        y_flat = stage_newton_solve(f_at, base_flat, gdt, base_flat, newton_iters)
        safe = torch.where(gdt == 0, torch.ones_like(gdt), gdt)
        return tree_leaves(unravel((y_flat - base_flat) / safe)), tree_leaves(unravel(y_flat))

    def dirk_stages(y0_, f0_, t0_, dt_, t1_):
        y0_l, spec = tree_flatten(y0_)
        g0 = float(tableau.diag[0])
        if g0 == 0.0:
            ks = [tree_leaves(f0_)]
        else:  # c_1 = a_11 = g0; f0 is not a stage derivative here
            ks = [stage_solve(t0_ + g0 * dt_, dt_, y0_, g0)[0]]
        yi_l = y0_l
        for i in range(n_stages - 1):
            alpha_i = float(tableau.alpha[i])
            ti = t1_ if alpha_i == 1.0 else t0_ + alpha_i * dt_
            base = tree_unflatten(base_of(y0_l, ks, i, dt_), spec)
            k_i, yi_l = stage_solve(ti, dt_, base, float(tableau.diag[i + 1]))
            ks.append(k_i)
        return ks, yi_l

    stages = dirk_stages if tableau.implicit else explicit_stages

    def runge_kutta_step(y0_, f0_, t0_, dt_, t1_):
        y0_l, spec = tree_flatten(y0_)
        ks, yi_l = stages(y0_, f0_, t0_, dt_, t1_)
        k_l = [torch.stack([k[j] for k in ks]) for j in range(len(y0_l))]
        if tableau.fsal:
            y1_l = yi_l  # the last stage input is the solution
        else:
            y1_l = [y + _weighted(weights(y.dtype, y.device)["c_sol"], k) * dt_.to(y.dtype)
                    for y, k in zip(y0_l, k_l)]
        err_l = [_weighted(weights(k.dtype, k.device)["c_error"], k - k[0]) * dt_.to(k.dtype)
                 for k in k_l]
        return (tree_unflatten(y1_l, spec), tree_unflatten(ks[-1], spec),
                tree_unflatten(err_l, spec), tree_unflatten(k_l, spec))

    def interp_fit_step(y0_, y1_, k, dt_, f0_):
        y_mid = tree_map(
            lambda y, kl: y + _weighted(weights(y.dtype, y.device)["c_mid"], kl) * dt_.to(y.dtype),
            y0_, k,
        )
        f1_ = tree_map(lambda kl: kl[-1], k)
        return interp_fit(y0_, y1_, y_mid, f0_, f1_, dt_)

    return runge_kutta_step, interp_fit_step


def _all_finite(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.stack([torch.isfinite(leaf).all() for leaf in leaves]).all()


def make_adaptive_step(term, tableau, rtol, atol, norm, safety, ifactor, dfactor,
                       min_step, max_step, step_t=None, jump_t=None, newton_iters=6,
                       watch=None):
    """The ``RKState -> RKState`` step (the JAX engine's ``adaptive_step``),
    shared by the per-output engine, the buffered-dense engine and the
    adjoint's single-pass backward.

    ``step_t``/``jump_t``: sorted host arrays of the time dtype (or None).
    ``watch``: an optional ``(t1, y1) -> 0-dim tensor`` evaluated at every
    attempted step's end and read back in the same transfer as the accept
    flag (``RKState.watch``; the event search's sign test). Each call makes
    one device-to-host read."""
    order = tableau.order
    runge_kutta_step, interp_fit_step = make_rk_core(term, tableau, newton_iters)
    # field evaluations per attempted step (an implicit stage counts its
    # Newton iterations; sdirk4's implicit first stage is one more stage)
    stage_evals = tableau.n_stages - 1
    if tableau.implicit:
        stage_evals = (stage_evals + (float(tableau.diag[0]) != 0.0)) * newton_iters
    has_step_t = step_t is not None and len(step_t) > 0
    has_jump_t = jump_t is not None and len(jump_t) > 0
    check_max = not np.isposinf(max_step)

    def adaptive_step(s: RKState) -> RKState:
        y0_, f0_, t0_, dt = s.y1, s.f1, s.t1, s.dt
        t0d = t0_.detach()
        t1_ = t0d + dt  # never carries a gradient: the grid is data
        flags = [t1_ <= t0d, ~_all_finite(y0_)]

        on_step = on_jump = None  # None: known False on the host
        if has_step_t:
            nst = float(step_t[s.next_step_index])
            if s.t1_host < nst:
                on_step = nst < t1_
                t1_ = torch.where(on_step, torch.full_like(t1_, nst), t1_)
        if has_jump_t:
            njt = float(jump_t[s.next_jump_index])
            if s.t1_host < njt:
                on_jump = njt < t1_
                t1_ = torch.where(on_jump, torch.full_like(t1_, njt), t1_)
        if has_step_t or has_jump_t:
            dt_ = t1_ - t0_  # the JAX engine takes dt = t1 - t0 here
        elif t0_.requires_grad:
            dt_ = dt + (t0d - t0_)  # dt's value, d/dt0 = -1 as in t1 - t0
        else:
            dt_ = dt

        y1_, f1_, y1_error, k = runge_kutta_step(y0_, f0_, t0_, dt_, t1_)

        dtc = dt_.detach()
        error_ratio = compute_error_ratio(
            tree_map(torch.detach, y1_error), rtol, atol, tree_map(torch.detach, y0_),
            tree_map(torch.detach, y1_), norm)
        accept = error_ratio <= 1.0
        if check_max:
            accept = accept & ~(dtc > max_step)
        accept = accept | (dtc <= min_step)
        dt_next = optimal_step_size(dtc, error_ratio, safety, ifactor, dfactor, order)
        dt_next = torch.clamp(dt_next, min_step, max_step)

        flags = [accept] + flags + [f for f in (on_step, on_jump) if f is not None]
        extra = [t1_.detach().reshape(1)]
        if watch is not None:
            extra.insert(0, watch(t1_.detach(), tree_map(torch.detach, y1_)).detach().reshape(
                1).to(t1_.dtype))
        packed = torch.cat([torch.stack(flags).to(t1_.dtype)] + extra)
        vals = host_values(packed, "step")
        accepted = vals[0] != 0.0
        status = s.status | (DT_UNDERFLOW if vals[1] else 0) | (NON_FINITE if vals[2] else 0)
        pos = 3
        hit_step = hit_jump = False
        if on_step is not None:
            hit_step, pos = vals[pos] != 0.0, pos + 1
        if on_jump is not None:
            hit_jump = vals[pos] != 0.0
        hit_step = hit_step and not hit_jump

        nfe = s.nfe + stage_evals
        next_step_index, next_jump_index = s.next_step_index, s.next_jump_index
        watched = s.watch
        if accepted:
            coeff = interp_fit_step(y0_, y1_, k, dt_, f0_)
            y_next, f_next, t_next, t_next_host = y1_, f1_, t1_.detach(), vals[-1]
            if watch is not None:
                watched = vals[-2]
            if hit_jump:
                f_next = term.move(t_next, torch.zeros_like(t_next), y_next)
                nfe += 1
            if hit_step and next_step_index < len(step_t) - 1:
                next_step_index += 1
            if hit_jump and next_jump_index < len(jump_t) - 1:
                next_jump_index += 1
        else:
            coeff, y_next, f_next = s.interp_coeff, y0_, f0_
            t_next, t_next_host = t0_, s.t1_host
        return RKState(
            y1=y_next, f1=f_next, t0=t0_, t1=t_next, dt=dt_next, interp_coeff=coeff,
            next_step_index=next_step_index, next_jump_index=next_jump_index, nfe=nfe,
            n_accept=s.n_accept + int(accepted), n_reject=s.n_reject + int(not accepted),
            status=status, t1_host=t_next_host, watch=watched,
        )

    return adaptive_step


def initial_state(term, tableau, y0, t0, t_end, t0_host, rtol, atol, norm, first_step,
                  time_dtype, step_index=0, jump_index=0) -> RKState:
    """The engine's state before its first step: ``f0 = move(t0, t_end - t0,
    y0)``, the initial ``dt`` from ``first_step`` or the Hairer heuristic
    (detached: the grid carries no gradient)."""
    f0 = term.move(t0, t_end - t0, y0)
    if first_step is None:
        dt0 = select_initial_step(term.move, t0.detach(), tree_map(torch.detach, y0),
                                  tableau.order - 1, rtol, atol, norm=norm,
                                  f0=tree_map(torch.detach, f0))
    else:
        dt0 = torch.as_tensor(first_step, dtype=time_dtype, device=t0.device)
    zero_coeff = [y0] + [tree_map(torch.zeros_like, y0)] * 4
    return RKState(
        y1=y0, f1=f0, t0=t0, t1=t0, dt=dt0.detach().to(time_dtype), interp_coeff=zero_coeff,
        next_step_index=step_index, next_jump_index=jump_index, nfe=1, n_accept=0,
        n_reject=0, status=0, t1_host=float(t0_host),
    )


def stats_of(s: RKState, status: Optional[int] = None) -> AdaptiveStats:
    return AdaptiveStats(nfe=s.nfe, n_accept=s.n_accept, n_reject=s.n_reject,
                         status=s.status if status is None else status)


def host_times(t_span: torch.Tensor, t_host=None):
    """``t_span``'s values on the host: ``t_host`` when the caller has them,
    else one read (none when ``t_span`` already lies on the CPU)."""
    if t_host is not None:
        return np.asarray(t_host, np_dtype(t_span.dtype))
    if t_span.device.type == "cpu":
        return host_array(t_span)
    return np.asarray(host_values(t_span, "setup"), np_dtype(t_span.dtype))


def prepare_times(y0, t_span, time_dtype=None, t_host=None):
    """(t on the state's device in the time dtype, its host values)."""
    t_span = torch.as_tensor(t_span)
    time_dtype = time_dtype_of(t_span, time_dtype)
    host = host_times(t_span, t_host).astype(np_dtype(time_dtype))
    device = tree_leaves(y0)[0].device
    return t_span.to(device=device, dtype=time_dtype), host


def _sorted_host(tvals, t0_host, dtype):
    """``sort_tvals`` on the host: values before ``t0`` become +inf."""
    if isinstance(tvals, torch.Tensor):
        tvals = host_array(tvals) if tvals.device.type == "cpu" else np.asarray(
            host_values(tvals, "setup"))
    arr = np.asarray(tvals, dtype).reshape(-1)
    arr = np.where(arr >= dtype(t0_host), arr, dtype(np.inf))
    return np.sort(arr)


def warn_grid_overflow(solution, stats: AdaptiveStats, grid_buffer: int, overflow_warn: bool):
    """The JAX package's ``grid_buffer`` warning for a differentiated solve
    (the gradient here stays exact; module docstring)."""
    if not overflow_warn or stats.n_accept <= grid_buffer:
        return
    if any(leaf.requires_grad for leaf in tree_leaves(solution)):
        warnings.warn(
            "adaptive odeint direct-gradient grid_buffer overflow: the solve accepted "
            f"{stats.n_accept} steps, more than grid_buffer={grid_buffer}. PyTorch keeps the "
            "exact gradient over every step (the JAX package coarsens the tail); raise "
            "options={'grid_buffer': N}, use odeint_adjoint for O(1) memory, or silence with "
            "options={'overflow_warn': False}.",
            RuntimeWarning, stacklevel=3,
        )


def solve_adaptive(
    term: XDETerm,
    y0,
    t_span,
    *,
    method: str = "dopri5",
    rtol=1e-7,
    atol=1e-9,
    norm: Callable = rms_norm,
    first_step=None,
    safety=0.9,
    ifactor=10.0,
    dfactor=0.2,
    min_step=0.0,
    max_step=float("inf"),
    max_num_steps: int = 2**31 - 1,
    step_t=None,
    jump_t=None,
    return_stats: bool = False,
    time_dtype=None,
    newton_iters: int = 6,
    direct_grad: bool = True,
    grid_buffer: int = 512,
    overflow_warn: bool = True,
    _t_host=None,
):
    """Integrate ``term`` over ``t_span`` (strictly increasing), adaptively.

    Returns a time-first ``[T, ...]`` tree (plus :class:`AdaptiveStats` when
    ``return_stats``). ``max_num_steps`` bounds the attempted steps per
    output interval, as in the JAX engine. ``newton_iters``: the Newton
    iterations of an implicit stage (the DIRK tableaus)."""
    tableau = TABLEAUS[method] if isinstance(method, str) else method
    with torch.set_grad_enabled(torch.is_grad_enabled() and direct_grad):
        sol, stats = _solve_adaptive(term, y0, t_span, tableau, rtol, atol, norm, first_step,
                                     safety, ifactor, dfactor, min_step, max_step,
                                     max_num_steps, step_t, jump_t, time_dtype, _t_host,
                                     newton_iters)
    warn_grid_overflow(sol, stats, grid_buffer, overflow_warn)
    return (sol, stats) if return_stats else sol


def _solve_adaptive(term, y0, t_span, tableau, rtol, atol, norm, first_step, safety, ifactor,
                    dfactor, min_step, max_step, max_num_steps, step_t, jump_t, time_dtype,
                    t_host, newton_iters):
    t_dev, t_host = prepare_times(y0, t_span, time_dtype, t_host)
    time_dtype = t_dev.dtype
    ndt = np_dtype(time_dtype)
    t0 = t_dev[0]
    step_t_h = _sorted_host(step_t, t_host[0], ndt) if step_t is not None and np.size(
        step_t) > 0 else None
    jump_t_h = _sorted_host(jump_t, t_host[0], ndt) if jump_t is not None and np.size(
        jump_t) > 0 else None

    def idx_init(grid):
        # first element strictly greater than t0, clipped to len-1
        return min(int(np.searchsorted(grid, t_host[0], side="right")), len(grid) - 1)

    state = initial_state(
        term, tableau, y0, t0, t_dev[-1], t_host[0], rtol, atol, norm, first_step, time_dtype,
        step_index=idx_init(step_t_h) if step_t_h is not None else 0,
        jump_index=idx_init(jump_t_h) if jump_t_h is not None else 0,
    )
    step = make_adaptive_step(term, tableau, rtol, atol, norm, safety, ifactor, dfactor,
                              min_step, max_step, step_t_h, jump_t_h, newton_iters)

    def evaluate(s, start, stop):
        # the outputs [start, stop), covered by the current step, in one pass
        tq = t_dev[start:stop]
        t_eval = torch.minimum(torch.maximum(tq, s.t0), s.t1)
        return interp_evaluate(s.interp_coeff, s.t0, s.t1, t_eval)

    pieces = [tree_map(lambda a: a[None], y0)]
    pending = 1  # outputs [pending, i) wait for the state that covers them
    for i in range(1, len(t_host)):
        next_t = float(t_host[i])
        n = 0
        while next_t > state.t1_host and n < max_num_steps and state.status == 0:
            if pending < i:
                pieces.append(evaluate(state, pending, i))
                pending = i
            state = step(state)
            n += 1
        if next_t > state.t1_host and n >= max_num_steps:
            state = state._replace(status=state.status | MAX_STEPS_EXCEEDED)
    if pending < len(t_host):
        pieces.append(evaluate(state, pending, len(t_host)))

    solution = tree_map(lambda *ps: torch.cat([p.to(ps[-1].dtype) for p in ps]), *pieces)
    return solution, stats_of(state)
