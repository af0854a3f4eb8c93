"""O(1)-memory adjoint gradients for odeint.

Counterpart of ``paddlexde_tpu/functional/odeint_adjoint.py`` (itself a
rebuild of the reference's ``OdeintAdjointMethod``,
``paddlexde/functional/odeint_adjoint.py:11-167``), as a
``torch.autograd.Function`` whose backward integrates the augmented system
``(adj_t, y, adj_y, adj_params)`` backward in time:

- the vector-Jacobian products of the augmented field come from
  ``torch.autograd.grad`` on a re-evaluated ``func``;
- the norm on the augmented state is the mixed norm (max of the members'
  RMS) by default; ``adjoint_options={"norm": "seminorm"}`` leaves the
  parameter cotangents out of step control, or pass a callable (``:49-65``);
- with an adaptive adjoint solver and a strictly monotone span of more than
  two outputs, one solve covers the whole reversed span, landing on every
  output by ``step_t`` and injecting the incoming cotangent and the saved
  forward state there (``:68-206``); otherwise one solve per output
  interval, with the forward grid's step count (``k_sub``) for fixed
  solvers (``:355-386``);
- a backward solve that fails (status bits, or the span not reached) gives
  NaN gradients, never a silently truncated adjoint (``:201-203, :423``);
- the ``t_span`` cotangent is ``<grad_i, f(t_i, y_i)>`` per output, the
  integrated ``adj_t`` landing on ``t_0``;
- symplectic solvers are refused.

Parameters: JAX finds the arrays ``func`` closes over by
``jax.closure_convert``, which PyTorch cannot do. The port takes
``adjoint_params`` (as the reference and torchdiffeq do), by default
``func.parameters()`` when ``func`` is an ``nn.Module``. When there are no
such parameters and ``func``'s output needs a gradient for some other
tensor it closes over, ``odeint_adjoint`` raises instead of dropping that
gradient. A tensor closed over by an ``nn.Module`` ``func`` that is not one
of its parameters, and not in ``adjoint_params``, gets no gradient.

``BACKWARD_STATS`` holds the last backward's counts: the augmented-field
evaluations of its solves (``nfe``, each one ``func`` call and one
vector-Jacobian product), their accepted and rejected steps and status,
and ``f_evals``, the ``func`` calls of the ``t_span`` cotangent.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_leaves, tree_map, tree_unflatten

from .._device import input_device, place
from ..solver.adaptive import (
    TABLEAUS,
    RKState,
    host_times,
    make_adaptive_step,
    np_dtype,
    time_dtype_of,
)
from ..solver.registry import SolverSpec, resolve_solver
from ..utils.norms import rms_norm
from ..utils.ode_utils import select_initial_step
from ..xde.term import XDETerm, ode_term
from .solve import format_solution, integrate_term

__all__ = ["odeint_adjoint", "BACKWARD_STATS"]

BACKWARD_STATS: Dict[str, object] = {}

_SYMPLECTIC = ("leapfrog", "velocity_verlet", "yoshida4")


def _name(solver):
    if isinstance(solver, SolverSpec):
        return solver.name
    return solver.lower() if isinstance(solver, str) else None


def _tree_dot(a, b) -> torch.Tensor:
    """<a, b> summed over all leaves."""
    return sum(torch.sum(x * y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _max_of(members):
    dtype = members[0].dtype
    for m in members[1:]:
        dtype = torch.promote_types(dtype, m.dtype)
    return torch.stack([m.to(dtype) for m in members]).max()


def _make_adjoint_norm(option) -> Callable:
    """The norm over the augmented tree ``(adj_t, y, adj_y, adj_p)``."""
    if callable(option):
        return option
    include_params = option != "seminorm"

    def norm(aug):
        adj_t, y, adj_y, adj_p = aug
        members = [torch.abs(adj_t), rms_norm(y), rms_norm(adj_y)]
        if include_params:
            members.extend(rms_norm(leaf) for leaf in tree_leaves(adj_p))
        return _max_of(members)

    return norm


def _augmented_dynamics(func, params):
    """``(t, aug) -> (-a.df/dt, f, -a.df/dy, -a.df/dp)`` by one
    ``torch.autograd.grad`` of a re-evaluated ``func``. When the augmented
    state itself carries a graph (an implicit adjoint solver linearizes
    this field), the vector-Jacobian product is taken with
    ``create_graph`` and stays differentiable in ``y`` and ``a``."""

    def dynamics(t, aug):
        _, y, adj_y, _ = aug
        graph = torch.is_grad_enabled() and any(
            leaf.requires_grad for leaf in tree_leaves((y, adj_y)))
        with torch.enable_grad():
            t_ = t.detach().requires_grad_(True)
            y_ = tree_map(lambda a: a if graph and a.requires_grad
                          else a.detach().requires_grad_(True), y)
            fval = func(t_, y_)
            inputs = [t_] + tree_leaves(y_) + list(params)
            pairs = [(f, -a) for f, a in zip(tree_leaves(fval), tree_leaves(adj_y))
                     if f.requires_grad]
            grads = [None] * len(inputs)
            if pairs:
                grads = torch.autograd.grad([f for f, _ in pairs], inputs,
                                            [a for _, a in pairs], allow_unused=True,
                                            create_graph=graph)
        grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, inputs)]
        n_y = len(tree_leaves(y_))
        _, y_spec = tree_flatten(y)
        out_f = fval if graph else tree_map(torch.detach, fval)
        return (grads[0], out_f, tree_unflatten(grads[1:1 + n_y], y_spec),
                tuple(grads[1 + n_y:]))

    return dynamics


def _single_pass_backward(bwd_term, func, sol, ts, t_host, grads, zeros_p, span_sign, tableau,
                          rtol, atol, norm, opts, stats):
    """One adaptive solve over the whole reversed span (``:68-206``)."""
    n_out = ts.shape[0]
    time_dtype = ts.dtype
    s_grid = (span_sign * ts).flip(0)
    s_host = (span_sign * t_host)[::-1].copy()
    s_end = float(s_host[-1])

    def take(tree, i):
        return tree_map(lambda a: a[i], tree)

    # dL/dt_i = <grad_i, f(t_i, y_i)> for every output
    dLd_ts = torch.stack([_tree_dot(take(grads, i), func(ts[i], take(sol, i))).to(time_dtype)
                          for i in range(n_out)])
    stats["f_evals"] += n_out
    dLd_rev = dLd_ts.flip(0)

    def rev(i):
        return n_out - 1 - i

    aug0 = (-dLd_rev[0], take(sol, rev(0)), take(grads, rev(0)), zeros_p)
    s0 = s_grid[0]
    zero = torch.zeros((), dtype=time_dtype, device=ts.device)
    f0 = bwd_term.move(s0, zero, aug0)
    if opts.get("first_step") is None:
        dt0 = select_initial_step(bwd_term.move, s0, aug0, tableau.order - 1, rtol, atol,
                                  norm=norm, f0=f0)
    else:
        dt0 = torch.as_tensor(opts["first_step"], dtype=time_dtype, device=ts.device)
    step = make_adaptive_step(
        bwd_term, tableau, rtol, atol, norm, opts.get("safety", 0.9), opts.get("ifactor", 10.0),
        opts.get("dfactor", 0.2), opts.get("min_step", 0.0), opts.get("max_step", float("inf")),
        step_t=s_host[1:],  # land exactly on every output boundary
    )
    zero_coeff = [aug0] + [tree_map(torch.zeros_like, aug0)] * 4
    s = RKState(y1=aug0, f1=f0, t0=s0, t1=s0, dt=dt0.to(time_dtype), interp_coeff=zero_coeff,
                next_step_index=0, next_jump_index=0, nfe=1, n_accept=0, n_reject=0, status=0,
                t1_host=float(s_host[0]))
    max_iters = int(opts.get("max_num_steps", 2**31 - 1))
    ptr, n_it = 1, 0
    while s.t1_host < s_end and n_it < max_iters and s.status == 0:
        s2 = step(s)
        # landed on the next interior output boundary: inject its cotangent
        # and re-inject the saved forward state
        if s2.t1_host >= s_host[min(ptr, n_out - 1)] and ptr < n_out - 1:
            adj_t, _, adj_y, adj_p = s2.y1
            aug_new = (adj_t - dLd_rev[ptr], take(sol, rev(ptr)),
                       tree_map(torch.add, adj_y, take(grads, rev(ptr))), adj_p)
            s2 = s2._replace(y1=aug_new, f1=bwd_term.move(s2.t1, zero, aug_new),
                             nfe=s2.nfe + 1)
            ptr += 1
        s, n_it = s2, n_it + 1

    adj_t, _, adj_y, adj_p = s.y1
    adj_y = tree_map(torch.add, adj_y, take(grads, 0))
    grad_ts = torch.cat([adj_t.reshape(1).to(time_dtype), dLd_ts[1:]])
    stats.update(nfe=stats["nfe"] + s.nfe, n_accept=stats["n_accept"] + s.n_accept,
                 n_reject=stats["n_reject"] + s.n_reject, status=stats["status"] | s.status)
    bad = s.status != 0 or s.t1_host < s_end
    return adj_y, grad_ts, adj_p, bad


def _k_sub(adj_spec, adj_opts, options, t_host):
    """Sub-steps per interval for a fixed adjoint solver: the forward grid's
    finest step over the widest interval (``:355-386``)."""
    if adj_spec.kind != "fixed" or {"step_size", "grid", "grid_constructor"} & set(adj_opts):
        return None
    fwd = dict(options or {})
    h_fwd, width_max = fwd.get("step_size"), None
    if h_fwd is None and fwd.get("grid") is not None:
        g = np.asarray(torch.as_tensor(fwd["grid"]).detach().cpu())
        h_fwd = np.min(np.abs(np.diff(g)))
        width_max = np.abs(g[-1] - g[0])
    widths = np.abs(np.diff(t_host))
    if widths.size:
        width_max = widths.max()
    if h_fwd is None and fwd.get("grid_constructor") is not None:
        g = np.asarray(torch.as_tensor(fwd["grid_constructor"](torch.as_tensor(t_host))).cpu())
        h_fwd = np.min(np.abs(np.diff(g)))
    if h_fwd is None or width_max is None or float(h_fwd) <= 0:
        return None
    return int(min(65536, max(1, np.ceil(float(width_max) / float(h_fwd)))))


def _per_interval_backward(bwd_term, func, sol, ts, t_host, grads, zeros_p, span_sign,
                           adjoint_solver, adj_spec, rtol, atol, adj_opts, k_sub, stats):
    """One backward solve per output interval, from the last to the first."""
    n_out = ts.shape[0]
    adaptive = adj_spec.kind == "adaptive"
    hdt = np_dtype(ts.dtype)

    def take(tree, i):
        return tree_map(lambda a: a[i], tree)

    adj_t = torch.zeros((), dtype=ts.dtype, device=ts.device)
    adj_y = tree_map(torch.zeros_like, take(sol, 0))
    adj_p, bad = zeros_p, False
    dLd = [None] * n_out
    for i in range(n_out - 1, 0, -1):
        g_i = take(grads, i)
        adj_y = tree_map(torch.add, adj_y, g_i)
        dLd[i] = _tree_dot(g_i, func(ts[i], take(sol, i))).to(ts.dtype)
        stats["f_evals"] += 1
        adj_t = adj_t - dLd[i]
        aug0 = (adj_t, take(sol, i), adj_y, adj_p)
        # the interval's ends in s, from the host values (no device read)
        s_span = torch.as_tensor(span_sign * np.asarray([t_host[i], t_host[i - 1]], hdt))
        opts_i = dict(adj_opts)
        if k_sub is not None:
            opts_i["grid"] = torch.as_tensor(
                np.linspace(s_span[0].item(), s_span[1].item(), k_sub + 1).astype(hdt))
        if adaptive:
            opts_i.setdefault("first_step", 0.5 * abs(float(t_host[i]) - float(t_host[i - 1])))
            opts_i["return_stats"] = True
        out = integrate_term(bwd_term, aug0, s_span, adjoint_solver, rtol=rtol, atol=atol,
                             options=opts_i, time_axis=0)
        if adaptive:
            out, st = out
            bad = bad or st.status != 0
            stats.update(nfe=stats["nfe"] + st.nfe, n_accept=stats["n_accept"] + st.n_accept,
                         n_reject=stats["n_reject"] + st.n_reject,
                         status=stats["status"] | st.status)
        adj_t, _, adj_y, adj_p = take(out, 1)
    adj_y = tree_map(torch.add, adj_y, take(grads, 0))
    grad_ts = torch.stack([adj_t.to(ts.dtype)] + dLd[1:]) if n_out > 1 else adj_t.reshape(1)
    return adj_y, grad_ts, adj_p, bad


class _OdeintAdjoint(torch.autograd.Function):
    @staticmethod
    def forward(ctx, setup, t_span, *leaves):
        n_y = setup["n_y"]
        y0 = tree_unflatten(list(leaves[:n_y]), setup["y_spec"])
        # the span's host values stand in for it: no second read of the card
        t_in = torch.as_tensor(setup["t_host"]).to(t_span.dtype)
        out = integrate_term(ode_term(setup["func"]), y0, t_in, setup["solver"],
                             rtol=setup["rtol"], atol=setup["atol"], options=setup["options"],
                             time_axis=0)
        if isinstance(out, tuple):
            out, setup["stats"] = out
        sol = tree_leaves(out)
        ctx.setup = setup
        ctx.save_for_backward(t_span, *sol)
        return tuple(sol)

    @staticmethod
    def backward(ctx, *grad_sol):
        setup = ctx.setup
        t_span, *sol_l = ctx.saved_tensors
        func, params, t_host = setup["func"], setup["params"], setup["t_host"]
        n_out = t_host.shape[0]
        sol = tree_unflatten(sol_l, setup["y_spec"])
        grads = tree_unflatten([torch.zeros_like(s) if g is None else g
                                for g, s in zip(grad_sol, sol_l)], setup["y_spec"])
        device = sol_l[0].device
        time_dtype = time_dtype_of(t_span, setup["options"].get("time_dtype"))
        ts = t_span.detach().to(device=device, dtype=time_dtype)
        t_host = t_host.astype(np_dtype(time_dtype))

        aug_term = ode_term(_augmented_dynamics(func, params))
        reverse_span = n_out >= 2 and t_host[-1] < t_host[0]
        if reverse_span:
            bwd_term, span_sign = aug_term, 1.0
        else:
            # backward in time: the negated field over s = -t
            def move(s, ds, aug):
                return tree_map(torch.negative, aug_term.move(-s, -ds, aug))

            bwd_term, span_sign = XDETerm(move=move, fuse=aug_term.fuse), -1.0

        adj_opts = dict(setup["adjoint_options"])
        norm = _make_adjoint_norm(adj_opts.pop("norm", "mixed"))
        adj_opts["norm"] = norm
        adj_spec = resolve_solver(setup["adjoint_solver"])
        zeros_p = tuple(torch.zeros_like(p) for p in params)
        stats = {"nfe": 0, "n_accept": 0, "n_reject": 0, "status": 0, "f_evals": 0}
        diffs = np.diff(t_host)
        monotone = bool(np.all(diffs > 0) or np.all(diffs < 0))
        rtol, atol = setup["adjoint_rtol"], setup["adjoint_atol"]
        if adj_spec.kind == "adaptive" and monotone and n_out > 2:
            adj_y, grad_ts, adj_p, bad = _single_pass_backward(
                bwd_term, func, sol, ts, t_host, grads, zeros_p, span_sign,
                TABLEAUS[adj_spec.name], rtol, atol, norm, adj_opts, stats)
            stats["path"] = "single_pass"
        else:
            k_sub = _k_sub(adj_spec, adj_opts, setup["options"], t_host)
            adj_y, grad_ts, adj_p, bad = _per_interval_backward(
                bwd_term, func, sol, ts, t_host, grads, zeros_p, span_sign,
                setup["adjoint_solver"], adj_spec, rtol, atol, adj_opts, k_sub, stats)
            stats["path"] = "per_interval"
        BACKWARD_STATS.clear()
        BACKWARD_STATS.update(stats)

        def poison(x):
            # a failed backward solve is loud: NaN, not a truncated adjoint
            return torch.full_like(x, float("nan")) if bad else x

        grad_t = None
        if ctx.needs_input_grad[1]:
            grad_t = poison(grad_ts).to(device=t_span.device, dtype=t_span.dtype)
        return (None, grad_t, *[poison(a) for a in tree_leaves(adj_y)],
                *[poison(a) for a in adj_p])


def odeint_adjoint(
    func,
    y0,
    t_span,
    solver="dopri5",
    *,
    rtol=1e-7,
    atol=1e-9,
    options: Optional[dict] = None,
    adjoint_solver=None,
    adjoint_rtol=None,
    adjoint_atol=None,
    adjoint_options: Optional[dict] = None,
    adjoint_params=None,
    time_axis: int = -2,
):
    """Like :func:`~paddlexde_tpu_torch.functional.odeint.odeint`, but the
    gradients come from the augmented backward ODE in O(1) memory instead of
    autograd through the forward solve.

    ``adjoint_params``: the tensors to differentiate that ``func`` closes
    over (default: ``func.parameters()`` for an ``nn.Module``, else none;
    module docstring). ``adjoint_solver``/``adjoint_rtol``/``adjoint_atol``
    default to the forward's; ``adjoint_options`` takes the adaptive options
    and ``norm`` ("mixed", "seminorm" or a callable on the augmented tree).
    The forward values are ``odeint``'s with the same solver and options
    (with ``options={"return_stats": True}`` the forward's stats come back
    beside the solution).
    """
    if _name(solver) in _SYMPLECTIC or _name(adjoint_solver) in _SYMPLECTIC:
        raise ValueError(
            "symplectic solvers take a (q, p) pair state with a separable vector field; the "
            "adjoint's augmented backward system is neither -- differentiate odeint directly, "
            "or pass adjoint_solver='rk4' with a non-symplectic forward"
        )
    options = dict(options or {})
    if adjoint_params is None:
        params = tuple(func.parameters()) if isinstance(func, torch.nn.Module) else ()
    else:
        params = tuple(adjoint_params)
    params = tuple(p for p in params if p.requires_grad)

    t_span = torch.as_tensor(t_span)
    device = input_device(*tree_leaves(y0))
    y0 = tree_map(lambda a: place(a, device), y0)
    y_leaves, y_spec = tree_flatten(y0)
    if not params and torch.is_grad_enabled():
        with torch.enable_grad():
            probe = func(t_span[:1].detach().to(device).reshape(()),
                         tree_map(torch.detach, y0))
        if any(leaf.requires_grad for leaf in tree_leaves(probe)):
            raise ValueError(
                "func's output needs a gradient for a tensor it closes over, and odeint_adjoint "
                "cannot find it (PyTorch has no closure conversion): pass "
                "adjoint_params=(...), or make func an nn.Module"
            )
    setup = {
        "func": func, "params": params, "solver": solver, "rtol": rtol, "atol": atol,
        "options": options, "t_host": host_times(t_span),
        "adjoint_solver": solver if adjoint_solver is None else adjoint_solver,
        "adjoint_rtol": rtol if adjoint_rtol is None else adjoint_rtol,
        "adjoint_atol": atol if adjoint_atol is None else adjoint_atol,
        "adjoint_options": dict(adjoint_options or {}), "n_y": len(y_leaves), "y_spec": y_spec,
    }
    sol = _OdeintAdjoint.apply(setup, t_span, *y_leaves, *params)
    solution = format_solution(tree_unflatten(list(sol), y_spec), time_axis)
    if options.get("return_stats"):
        return solution, setup["stats"]
    return solution
