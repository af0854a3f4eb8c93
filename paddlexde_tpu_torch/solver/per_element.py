"""Adaptive step control per batch element: the batched controller.

Counterpart of ``jax.vmap`` over the JAX package's adaptive ``odeint``
(``functional/odeint.py::odeint_per_element``): every element of the
leading batch axis carries its own ``t0``/``t1``, ``dt``, dense output,
``nfe``, ``n_accept``, ``n_reject`` and ``status``, and takes the steps its
own error control asks for, as a vmapped ``while_loop`` does.

The loop runs on the host, over output times and attempted steps. One
attempted step is one batched step of every element still short of the
current output (the JAX engine's step arithmetic under ``torch.func.vmap``,
so ``func`` sees a scalar ``t`` and one element's state); an element that is
done keeps its state, selected by ``torch.where`` (a vmapped while loop's
masking). Each attempted step makes one device-to-host read, which brings
back whether an element is still short of the current output and the
smallest end time of the elements still running (which outputs the next
attempted step serves).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils._pytree import tree_leaves, tree_map

from ..utils.norms import rms_norm
from ..utils.ode_utils import (
    compute_error_ratio,
    interp_evaluate,
    optimal_step_size,
    select_initial_step,
)
from ..xde.term import XDETerm
from .adaptive import (
    DT_UNDERFLOW,
    MAX_STEPS_EXCEEDED,
    NON_FINITE,
    AdaptiveStats,
    host_values,
    make_rk_core,
    prepare_times,
)
from .tableaus import TABLEAUS

__all__ = ["solve_adaptive_per_element"]

_VMAP_HINT = (
    "odeint_per_element calls func under torch.func.vmap (a scalar t and one element's state "
    "per call); a field that reads values on the host (.item(), .tolist()) or branches on them "
    "in Python cannot be vmapped. Use odeint, which steps the batch with one shared step "
    "control.")


def _select(mask, new, old):
    """Per-element select of trees with a leading batch axis."""

    def leaf(a, b):
        return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)

    return tree_map(leaf, new, old)


def solve_adaptive_per_element(
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
    time_dtype=None,
    _t_host=None,
):
    """Integrate every element of ``y0``'s leading axis with its own step
    control; ``term`` is the single-element problem. Returns the time-first
    solution ``[T, B, ...]`` and :class:`AdaptiveStats` of ``[B]`` tensors
    on the device."""
    tableau = TABLEAUS[method] if isinstance(method, str) else method
    if tableau.implicit:
        raise ValueError(
            f"odeint_per_element runs the explicit adaptive solvers; {tableau.name!r} is "
            "implicit (use odeint)")
    t_dev, t_host = prepare_times(y0, t_span, time_dtype, _t_host)
    time_dtype, device = t_dev.dtype, t_dev.device
    batch = tree_leaves(y0)[0].shape[0]
    rk_step, fit_step = make_rk_core(term, tableau)
    vmap = torch.func.vmap
    order = tableau.order

    def move_one(t, y):
        return term.move(t, torch.zeros((), dtype=time_dtype, device=device), y)

    t0 = t_dev[0]
    t0_b = t0.expand(batch).contiguous()
    try:
        f0 = vmap(move_one)(t0_b, y0)
    except RuntimeError as exc:
        raise ValueError(_VMAP_HINT) from exc
    if first_step is None:
        dt = vmap(lambda y, f: select_initial_step(term.move, t0, y, order - 1, rtol, atol,
                                                   norm=norm, f0=f))(y0, f0)
    else:
        dt = torch.full((batch,), float(first_step), dtype=time_dtype, device=device)
    dt = dt.to(time_dtype)

    def finite_of(tree):
        return torch.stack([torch.isfinite(leaf.reshape(batch, -1)).all(1)
                            for leaf in tree_leaves(tree)]).all(0)

    def ratio_of(err, ya, yb):
        return vmap(lambda e, a, b: compute_error_ratio(e, rtol, atol, a, b, norm))(err, ya, yb)

    ints = {"dtype": torch.int64, "device": device}
    state = {
        "y": y0, "f": f0, "t0": t0_b, "t1": t0_b, "dt": dt,
        "coeff": [y0] + [tree_map(torch.zeros_like, y0)] * 4,
        "nfe": torch.ones(batch, **ints), "n_accept": torch.zeros(batch, **ints),
        "n_reject": torch.zeros(batch, **ints), "status": torch.zeros(batch, **ints),
    }

    def attempt(s, active):
        """One attempted step of every element; ``active`` ones keep it."""
        y0_, f0_, t0_, dt_ = s["y"], s["f"], s["t1"], s["dt"]
        t1_ = t0_ + dt_
        status = s["status"] | torch.where(t1_ <= t0_, DT_UNDERFLOW, 0) | torch.where(
            finite_of(y0_), 0, NON_FINITE)
        y1_, f1_, err, k = vmap(rk_step)(y0_, f0_, t0_, dt_, t1_)
        ratio = ratio_of(err, y0_, y1_)
        accept = ratio <= 1.0
        accept = torch.where(dt_ > max_step, False, accept)
        accept = torch.where(dt_ <= min_step, True, accept)
        coeff_new = vmap(fit_step)(y0_, y1_, k, dt_, f0_)
        dt_next = vmap(lambda d, r: optimal_step_size(d, r, safety, ifactor, dfactor, order))(
            dt_, ratio)
        dt_next = torch.clamp(dt_next, min_step, max_step)
        new = {
            "y": _select(accept, y1_, y0_), "f": _select(accept, f1_, f0_), "t0": t0_,
            "t1": torch.where(accept, t1_, t0_), "dt": dt_next,
            "coeff": [_select(accept, a, b) for a, b in zip(coeff_new, s["coeff"])],
            "nfe": s["nfe"] + (tableau.n_stages - 1), "n_accept": s["n_accept"] + accept,
            "n_reject": s["n_reject"] + ~accept, "status": status,
        }
        return {key: _select(active, value, s[key]) for key, value in new.items()}

    inf = torch.full((), float("inf"), dtype=time_dtype, device=device)
    pieces = [tree_map(lambda a: a[None], y0)]
    low_host = float(t_host[0])  # the smallest t1 of the running elements
    for i in range(1, len(t_host)):
        next_t = t_dev[i]
        n = torch.zeros(batch, **ints)
        more = float(t_host[i]) > low_host
        while more:
            active = (next_t > state["t1"]) & (n < max_num_steps) & (state["status"] == 0)
            state = attempt(state, active)
            n = n + active
            still = (next_t > state["t1"]) & (n < max_num_steps) & (state["status"] == 0)
            running = torch.where(state["status"] == 0, state["t1"], inf)
            vals = host_values(torch.stack([still.any().to(time_dtype), running.min()]), "step")
            more, low_host = vals[0] != 0.0, vals[1]
        hit_cap = (next_t > state["t1"]) & (n >= max_num_steps)
        state["status"] = state["status"] | torch.where(hit_cap, MAX_STEPS_EXCEEDED, 0)
        t_eval = torch.minimum(torch.maximum(next_t, state["t0"]), state["t1"])
        pieces.append(tree_map(lambda a: a[None], vmap(interp_evaluate)(
            state["coeff"], state["t0"], state["t1"], t_eval)))
    solution = tree_map(lambda *ps: torch.cat([p.to(ps[-1].dtype) for p in ps]), *pieces)
    stats = AdaptiveStats(nfe=state["nfe"], n_accept=state["n_accept"],
                          n_reject=state["n_reject"], status=state["status"])
    return solution, stats
