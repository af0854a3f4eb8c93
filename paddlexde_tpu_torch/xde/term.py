"""The XDE problem abstraction: the move/fuse two-hook contract.

Counterpart of ``paddlexde_tpu/xde/term.py``. A problem is an
:class:`XDETerm` of two functions closed over the user's vector field:
``move(t, dt, y)`` computes a derivative-like quantity and ``fuse(dy, dt,
y)`` applies it, so one solver zoo serves every family. States are tensors
or nested tuples/lists/dicts of tensors.

- ODE: move = f(t, y);  fuse = y + dy * dt.
- SDE: move = (f(t, y), g(t, y) * dW) with dW = bm(t, t + dt);  fuse = y +
  f * dt + g dW (Euler-Maruyama).
- DDE: move = func(y_lags, y) - damping * y (the damping folded into the
  field);  fuse = y + dy * dt.
- CDE: move = f(t, y) @ dX/dt(t);  fuse = y + dy * dt.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable

from torch.utils._pytree import tree_map

__all__ = ["XDETerm", "ode_term", "sde_term", "dde_term", "cde_term"]


@dataclasses.dataclass(frozen=True)
class XDETerm:
    """A differential-equation problem as two hooks.

    Attributes:
        move: ``(t, dt, y) -> dy``.
        fuse: ``(dy, dt, y) -> y_new``; affine in ``dy``.
        additive: True when ``fuse(dy, dt, y) == y + dt * dy``.
        kind: "ode" | "sde" | "dde" | "cde", for diagnostics.
    """

    move: Callable[[Any, Any, Any], Any]
    fuse: Callable[[Any, Any, Any], Any]
    additive: bool = True
    kind: str = "ode"


def _euler_fuse(dy, dt, y):
    return tree_map(lambda yl, dyl: yl + dt * dyl, y, dy)


def ode_term(func: Callable) -> XDETerm:
    """dy/dt = func(t, y)."""

    def move(t, dt, y):
        del dt
        return func(t, y)

    return XDETerm(move=move, fuse=_euler_fuse, additive=True, kind="ode")


def sde_term(drift: Callable, diffusion: Callable, bm: Callable) -> XDETerm:
    """dy = f dt + g dW with Euler-Maruyama semantics: ``bm(ta, tb)`` gives
    W(tb) - W(ta) (:mod:`paddlexde_tpu_torch.brownian`), ``move`` returns
    the pair ``(f(t, y), g(t, y) * dW)`` and ``fuse`` scales only the drift
    by ``dt``."""

    def move(t, dt, y):
        d_w = bm(t, t + dt)
        f_val = drift(t, y)
        g_val = diffusion(t, y)
        g_dw = tree_map(lambda g, w: g * w, g_val, d_w)
        return (f_val, g_dw)

    def fuse(dy, dt, y):
        f_val, g_dw = dy
        return tree_map(lambda yl, fl, gl: yl + dt * fl + gl, y, f_val, g_dw)

    return XDETerm(move=move, fuse=fuse, additive=False, kind="sde")


def _dde_call(func: Callable):
    """Resolve the DDE vector-field signature, once, by arity: the 2-arg
    ``func(y_lags, y)`` (D3STN), the 4-arg ``func(t, y, lags, y_lags)`` and
    the keyword form ``func(t, y, *, lags, y_lags)``."""
    try:
        params = inspect.signature(func).parameters
        names = list(params)
        has_kw = any(p.kind == inspect.Parameter.KEYWORD_ONLY for p in params.values())
    except (TypeError, ValueError):  # builtins / wrapped callables
        params, names, has_kw = {}, [], False

    if has_kw and {"lags", "y_lags"} <= set(names):
        return lambda t, y, lags, y_lags: func(t, y, lags=lags, y_lags=y_lags)
    positional = (inspect.Parameter.POSITIONAL_ONLY, inspect.Parameter.POSITIONAL_OR_KEYWORD)
    n_pos = len([p for p in params.values() if p.kind in positional]) if names else 2
    if n_pos >= 4:
        return lambda t, y, lags, y_lags: func(t, y, lags, y_lags)
    return lambda t, y, lags, y_lags: func(y_lags, y)


def dde_term(func: Callable, lags, y_lags, damping: float = 1e-3) -> XDETerm:
    """Delay DE with a precomputed history lookup ``y_lags`` (from
    :func:`~paddlexde_tpu_torch.xde.history.history_index`). The damping is
    folded into the vector field, ``f_eff = f - damping * y``; broadcasting
    applies, so a ``[..., 1]`` field against a ``[..., C]`` state gives a
    ``[..., C]`` derivative."""
    call = _dde_call(func)

    def move(t, dt, y):
        del dt
        dy = call(t, y, lags, y_lags)
        if not damping:
            return dy
        return tree_map(lambda d, yl: d - damping * yl, dy, y)

    return XDETerm(move=move, fuse=_euler_fuse, additive=True, kind="dde")


def cde_term(func: Callable, control_deriv: Callable) -> XDETerm:
    """Neural controlled DE: dy = f(t, y) @ dX/dt dt, with ``func(t, y) ->
    [..., D_y, D_x]`` (a matrix field) and ``control_deriv(t) -> [..., D_x]``
    (the derivative of the interpolated control, e.g.
    ``CubicHermiteSpline(...).derivative``)."""

    def move(t, dt, y):
        del dt
        mat = func(t, y)
        d_x = control_deriv(t)
        return tree_map(lambda m, dx: (m @ dx.unsqueeze(-1)).squeeze(-1), mat, d_x)

    return XDETerm(move=move, fuse=_euler_fuse, additive=True, kind="cde")
