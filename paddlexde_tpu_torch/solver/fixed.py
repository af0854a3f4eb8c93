"""Fixed-grid solvers.

Counterpart of ``paddlexde_tpu/solver/fixed.py``: euler, midpoint, rk4,
and in the step table the symplectic (``symplectic.py``) and implicit
(``implicit.py``) steps.
The JAX package runs the grid as one ``lax.scan``; here it is a Python loop
over the grid steps (PyTorch runs eagerly). Dense output collects
``(y_i, dy_i)`` at every node, then evaluates all requested output times at
once by bucketising and 2-point (linear or cubic Hermite) interpolation.

Output layout is time-first ``[T, ...]``; the functional layer moves the
time axis at the API edge.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.utils.checkpoint
from torch.utils._pytree import tree_map

from ..utils.misc import host_array
from ..xde.term import XDETerm
from . import implicit, symplectic

__all__ = ["euler_step", "midpoint_step", "rk4_step", "make_grid", "solve_fixed",
           "FIXED_STEP_FNS"]

_one_third = 1.0 / 3.0
_two_thirds = 2.0 / 3.0


def euler_step(term: XDETerm, t0, t1, y0):
    """Order 1."""
    dt = t1 - t0
    dy0 = term.move(t0, dt, y0)
    return term.fuse(dy0, dt, y0), dy0


def midpoint_step(term: XDETerm, t0, t1, y0):
    """Order 2."""
    dt = t1 - t0
    half_dt = 0.5 * dt
    k1 = term.move(t0, dt, y0)
    y_mid = term.fuse(k1, half_dt, y0)
    k2 = term.move(t0 + half_dt, half_dt, y_mid)
    return term.fuse(k2, dt, y0), k1


def rk4_step(term: XDETerm, t0, t1, y0):
    """Kutta's 3/8 rule, order 4, in move/fuse form (the corrected third
    stage ``fuse(k2 - k1/3)`` of the JAX package)."""
    dt = t1 - t0
    dt_third = dt * _one_third

    def comb(*pairs):
        coeffs = [c for c, _ in pairs]
        trees = [k for _, k in pairs]
        return tree_map(lambda *ls: sum(c * l for c, l in zip(coeffs, ls)), *trees)

    k1 = term.move(t0, dt, y0)
    k2 = term.move(t0 + dt_third, dt_third, term.fuse(k1, dt_third, y0))
    k3 = term.move(
        t0 + dt * _two_thirds, dt_third,
        term.fuse(comb((1.0, k2), (-_one_third, k1)), dt, y0),
    )
    k4 = term.move(t1, dt_third, term.fuse(comb((1.0, k1), (-1.0, k2), (1.0, k3)), dt, y0))
    dy = comb((0.125, k1), (0.375, k2), (0.375, k3), (0.125, k4))
    return term.fuse(dy, dt, y0), k1


FIXED_STEP_FNS = {
    "euler": (euler_step, 1),
    "midpoint": (midpoint_step, 2),
    "rk4": (rk4_step, 4),
    "leapfrog": (symplectic.leapfrog_step, 2),
    "velocity_verlet": (symplectic.leapfrog_step, 2),
    "yoshida4": (symplectic.yoshida4_step, 4),
    "implicit_euler": (implicit.implicit_euler_step, 1),
    "implicit_midpoint": (implicit.implicit_midpoint_step, 2),
    "gauss_legendre1": (implicit.implicit_midpoint_step, 2),
    "implicit_euler_krylov": (implicit.implicit_euler_krylov_step, 1),
    "sdirk2": (implicit.sdirk2_step, 2),
    "sdirk2_krylov": (implicit.sdirk2_krylov_step, 2),
    "sdirk3": (implicit.sdirk3_step, 3),
}


def make_grid(t_span, step_size=None, grid_constructor: Optional[Callable] = None, grid=None):
    """Build the integration grid: ``t_span`` itself by default; an arange
    grid with the last node snapped to ``t_span[-1]`` for ``step_size``; or
    the given ``grid`` / ``grid_constructor(t_span)``. Mutually exclusive."""
    if sum(x is not None for x in (step_size, grid_constructor, grid)) > 1:
        raise ValueError("step_size, grid_constructor and grid are mutually exclusive arguments.")
    t_span = torch.as_tensor(t_span)
    if grid is not None:
        return torch.as_tensor(grid, device=t_span.device)
    if grid_constructor is not None:
        return torch.as_tensor(grid_constructor(t_span), device=t_span.device)
    if step_size is None:
        return t_span
    ct = host_array(t_span)
    start, end = float(ct[0]), float(ct[-1])
    n = int(np.ceil(abs(end - start) / float(abs(step_size)) + 1.0))
    sign = 1.0 if end >= start else -1.0
    out = np.arange(n, dtype=ct.dtype) * (sign * abs(step_size)) + start
    out[-1] = end
    return torch.as_tensor(out, device=t_span.device)


def solve_fixed(
    term: XDETerm,
    y0,
    t_span,
    *,
    method="euler",
    interp: str = "linear",
    step_size=None,
    grid_constructor: Optional[Callable] = None,
    grid=None,
    time_dtype=None,
    checkpoint: bool = False,
):
    """Integrate over a fixed grid; return a ``[T, ...]`` time-first state.

    ``interp``: "linear" | "cubic" | "" -- how requested output times that
    fall strictly inside grid intervals are reconstructed.

    ``checkpoint``: run each step under ``torch.utils.checkpoint`` (the JAX
    package's ``jax.checkpoint`` per step, ``solver/fixed.py:204-224``):
    backprop recomputes a step's stages instead of keeping them.
    """
    step_fn = FIXED_STEP_FNS[method][0] if isinstance(method, str) else method
    if checkpoint:
        inner_step = step_fn

        def step_fn(term_, t0, t1, y):
            return torch.utils.checkpoint.checkpoint(
                lambda a, b, c: inner_step(term_, a, b, c), t0, t1, y, use_reentrant=False)

    t_span = torch.as_tensor(t_span)
    if time_dtype is not None:
        t_span = t_span.to(time_dtype)
    grid_is_tspan = step_size is None and grid_constructor is None and grid is None
    grid = make_grid(
        t_span, step_size=step_size, grid_constructor=grid_constructor, grid=grid
    ).to(t_span.dtype)

    y, ys, dys = y0, [y0], []
    for i in range(grid.shape[0] - 1):
        y, dy = step_fn(term, grid[i], grid[i + 1], y)
        ys.append(y)
        dys.append(dy)
    ys_all = tree_map(lambda *ls: torch.stack(ls, dim=0), *ys)

    if grid_is_tspan and interp in ("linear", "cubic", "", None):
        # output times coincide with grid nodes: every mode is the step endpoint
        return ys_all

    first, last = host_array(grid[[0, -1]]).tolist()
    direction = 1 if last >= first else -1
    idx = (
        torch.searchsorted((direction * grid).contiguous(), (direction * t_span).contiguous(),
                           right=True) - 1
    ).clamp(0, grid.shape[0] - 2)
    t0g, t1g = grid[idx], grid[idx + 1]
    y0g = tree_map(lambda a: a[idx], ys_all)
    y1g = tree_map(lambda a: a[idx + 1], ys_all)
    if interp == "cubic":
        # derivative at the last node: one extra zero-width move
        dy_last = term.move(grid[-1], torch.zeros((), dtype=grid.dtype, device=grid.device), y)
        dys_all = tree_map(lambda *ls: torch.stack(ls, dim=0), *dys, dy_last)
        dy0g = tree_map(lambda a: a[idx], dys_all)
        dy1g = tree_map(lambda a: a[idx + 1], dys_all)
        return _cubic_hermite(t0g, y0g, dy0g, t1g, y1g, dy1g, t_span)
    return _linear(t0g, y0g, t1g, y1g, t_span)


def _expand(tvec, leaf):
    """Broadcast per-output-time scalars [T] against a time-first leaf [T, ...]."""
    return tvec.reshape(tvec.shape + (1,) * (leaf.dim() - 1)).to(leaf.device, leaf.dtype)


def _linear(t0, y0, t1, y1, t):
    denom = torch.where(t1 == t0, torch.ones_like(t0), t1 - t0)
    w = torch.where(t1 == t0, torch.zeros_like(t0), (t - t0) / denom)
    return tree_map(lambda a, b: a + _expand(w, a) * (b - a), y0, y1)


def _cubic_hermite(t0, y0, dy0, t1, y1, dy1, t):
    denom = torch.where(t1 == t0, torch.ones_like(t0), t1 - t0)
    h = torch.where(t1 == t0, torch.zeros_like(t0), (t - t0) / denom)
    h00 = (1 + 2 * h) * (1 - h) ** 2
    h10 = h * (1 - h) ** 2
    h01 = h**2 * (3 - 2 * h)
    h11 = h**2 * (h - 1)

    def leaf(a, da, b, db):
        return (
            _expand(h00, a) * a
            + _expand(h10 * denom, a) * da
            + _expand(h01, a) * b
            + _expand(h11 * denom, a) * db
        )

    return tree_map(leaf, y0, dy0, y1, dy1)
