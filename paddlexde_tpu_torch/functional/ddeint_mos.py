"""ddeint_mos: true delay differential equations by the method of steps.

Counterpart of ``paddlexde_tpu/functional/ddeint_mos.py:54-235``, same
signature, checks and error texts. :func:`ddeint` evaluates the lagged state
once against a fixed pre-t0 history window (the reference's learned-lag
design); this solves

    y'(t) = f(t, y(t), [y(t - tau_1), ..., y(t - tau_L)]),  y(t) = phi(t) for t <= t0

where the delayed value re-enters the computed solution. On a uniform grid
each step writes a knot ``(y_k, f_k)``; every stage's lagged lookup
cubic-Hermite-interpolates the written knots (the history spline below t0),
so rk4 keeps its order away from the breaking points.

The port's form of the JAX scan:

- the knots live in two lists, stacked once per step for the lookups, not
  written in place into a buffer that autograd has already read, so the
  gradients reach the field's parameters, the lags and the history; with
  constant or tensor lags a step stacks only the newest
  ``ceil(max(lags) / h) + 2`` knots that its lookups can reach (a solve of
  n steps moves O(n max(lags) / h) knot values), with a callable lag all
  of them (O(n^2));
- the grid and the output times are float64 on the host (``:207, :234``);
  the lookups' segment index and offset are computed on the device, so the
  loop makes no device-to-host read; the solve makes at most one, of the
  values it checks (``min(lags)`` of a tensor lag, ``his_span[-1]``, a
  ``t_span`` on the card);
- the clamp of a violated state-dependent lag is the JAX one (``:153-171``):
  during step k the lookups see knots 0..k, a query past them reads the
  newest knot (the last segment at s = 1), and at k = 0 it reads y0 (s = 0).

The field gets ``t`` as a float64 0-dim CPU tensor, which mixes with tensors
on any device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .._device import input_device, place
from ..interpolation.interpolate import CubicHermiteSpline
from .solve import format_solution

__all__ = ["ddeint_mos"]


def _hermite(y0, y1, f0, f1, h, s):
    """Cubic Hermite on one segment; ``s`` in [0, 1]."""
    s2, s3 = s * s, s * s * s
    h00 = 2 * s3 - 3 * s2 + 1
    h10 = s3 - 2 * s2 + s
    h01 = -2 * s3 + 3 * s2
    h11 = s3 - s2
    return h00 * y0 + h10 * h * f0 + h01 * y1 + h11 * h * f1


def _host_values(*parts):
    """Each tensor of ``parts`` as a float64 numpy vector, those on a card
    read to the host together in one device-to-host copy."""
    out = [p.detach().reshape(-1).double() for p in parts]
    on_card = [i for i, p in enumerate(out) if p.device.type != "cpu"]
    if on_card:
        read = torch.cat([out[i] for i in on_card]).cpu()
        for i, piece in zip(on_card, read.split([out[i].numel() for i in on_card])):
            out[i] = piece
    return [p.numpy() for p in out]


def ddeint_mos(
    func,
    y0,
    t_span,
    lags,
    his,
    his_span,
    *,
    solver: str = "rk4",
    step_size: Optional[float] = None,
    time_axis: int = -2,
):
    """Solve a true DDE by the method of steps.

    Args:
        func: ``func(t, y, y_lags) -> dy`` with ``y [..., D]`` and
            ``y_lags [..., L, D]`` (the lag axis before the feature axis, as
            :func:`ddeint`'s ``y_lags``).
        y0: the state at ``t_span[0]``, ``[..., D]``.
        t_span: increasing output times (the solve runs on a uniform grid).
        lags: positive delays ``[L]``: numbers, or a tensor (gradients flow
            through the lookup's query and the solution's own dependence on
            the lag; at grid-aligned lags every query sits on a knot and the
            gradient is one-sided), or a callable ``lags(t, y) -> [L]`` for
            state-dependent delays, evaluated at every stage on the stage
            state (``tau(t, y) >= step_size`` along the solution is the
            caller's contract; a violation reads the newest written knot).
        his / his_span: the history knots ``[..., T_h, D]`` / ``[T_h]``,
            with ``his_span[-1] == t_span[0]``, interpolated by a cubic
            Hermite spline.
        solver: euler, midpoint or rk4.
        step_size: the uniform step h (default: the smallest ``t_span``
            spacing); ``h <= min(lags)``.

    Returns:
        the solution on ``t_span``, time at ``time_axis``. Tensors keep
        their device; numpy/list data follows the first tensor among
        ``y0``, ``his`` and ``lags``, else goes to the card.
    """
    lags_callable = callable(lags)
    device = input_device(y0, his, *(() if lags_callable else (lags,)))
    y0 = place(y0, device)
    his = place(his, device)
    t_in, span_in = torch.as_tensor(t_span), torch.as_tensor(his_span)
    checked = [t_in, span_in.reshape(-1)[-1:]]
    if not lags_callable:
        lags_arr = torch.atleast_1d(
            lags if isinstance(lags, torch.Tensor) else torch.as_tensor(lags, dtype=torch.float64))
        checked.append(lags_arr.reshape(-1))
    t_host, span_end, *lag_host = _host_values(*checked)

    if t_host.ndim != 1 or len(t_host) < 2 or np.any(np.diff(t_host) <= 0):
        raise ValueError("t_span must be 1-D increasing")
    t0, t1 = float(t_host[0]), float(t_host[-1])
    if step_size is None:
        step_size = float(np.min(np.diff(t_host)))
    h = float(step_size)
    if h <= 0:
        raise ValueError("step_size must be positive")
    if lags_callable:
        probe = torch.atleast_1d(torch.as_tensor(lags(torch.tensor(t0, dtype=torch.float64), y0)))
        if probe.dim() != 1:
            raise ValueError(
                "state-dependent lags(t, y) must return a rank-1 [L] "
                f"vector (got shape {tuple(probe.shape)}); for batched states "
                "with per-element delays, solve each element on its own"
            )
    else:
        min_lag = float(np.min(lag_host[0]))
        if min_lag < h - 1e-12:
            raise ValueError(
                f"method of steps needs step_size <= min(lags) (got h={h}, "
                f"min lag={min_lag}): an overlapping delay would read the "
                "current step's own output — shrink step_size"
            )
        lags_arr = lags_arr.to(device)
    if abs(float(span_end[0]) - t0) > 1e-9:
        raise ValueError(f"his_span must end at t_span[0]={t0} (got {float(span_end[0])})")
    n_steps = int(np.ceil((t1 - t0) / h - 1e-9))
    h = (t1 - t0) / n_steps  # exact tiling of the span

    hist = CubicHermiteSpline(his, span_in)

    # the knots a step's lookups can reach: the query t - tau of step k lies
    # at or above knot k - ceil(max_lag / h) (one more for the rounding of
    # its segment index); a callable lag may reach any
    window = None if lags_callable else int(np.ceil(float(np.max(lag_host[0])) / h)) + 2

    def lagged(knots_y, knots_f, base, k, t_q):
        """y at the query times ``t_q [L]``: the history spline at or below
        t0, above it the Hermite segment of the knots 0..k (``:148``), of
        which ``knots_y``/``knots_f`` hold ``base``..k."""
        from_hist = hist.evaluate(torch.clamp(t_q, max=t0))  # [..., L, D]
        pos = (t_q - t0) / h
        # a query below the window is at or below t0: torch.where drops it
        i = torch.floor(pos).long().clamp(base, max(k - 1, 0))
        s = torch.clamp(pos - i.to(pos.dtype), 0.0, 1.0)
        if k == 0:
            s = torch.zeros_like(s)
        if base:
            i = i - base  # into the window
        i1 = (i + 1).clamp(max=k - base)
        s = s.to(y0.dtype).reshape((-1,) + (1,) * (knots_y.dim() - 1))
        from_buf = _hermite(knots_y.index_select(0, i), knots_y.index_select(0, i1),
                            knots_f.index_select(0, i), knots_f.index_select(0, i1), h, s)
        from_buf = torch.movedim(from_buf, 0, -2)  # [..., L, D]
        return torch.where((t_q <= t0)[:, None], from_hist, from_buf)

    def f_eval(knots, k, t, y):
        t_t = torch.tensor(t, dtype=torch.float64)
        taus = torch.atleast_1d(torch.as_tensor(lags(t_t, y))) if lags_callable else lags_arr
        return func(t_t, y, lagged(*knots, k, t_t - taus))

    if solver not in ("euler", "midpoint", "rk4"):
        raise ValueError(f"ddeint_mos supports euler/midpoint/rk4, got {solver!r}")

    def step(knots, k, t, y, f_t):
        if solver == "euler":
            return y + h * f_t
        if solver == "midpoint":
            k2 = f_eval(knots, k, t + 0.5 * h, y + 0.5 * h * f_t)
            return y + h * k2
        k1 = f_t
        k2 = f_eval(knots, k, t + 0.5 * h, y + 0.5 * h * k1)
        k3 = f_eval(knots, k, t + 0.5 * h, y + 0.5 * h * k2)
        k4 = f_eval(knots, k, t + h, y + h * k3)
        return y + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)

    # f_0 sees an all-zero derivative buffer, as the JAX scan's first call
    ys = [y0]
    fs = [f_eval((y0[None], torch.zeros_like(y0)[None], 0), 0, t0, y0)]
    for k in range(n_steps):
        t = t0 + k * h
        base = 0 if window is None else max(0, k + 1 - window)
        knots = (torch.stack(ys[base:]), torch.stack(fs[base:]), base)
        y1 = step(knots, k, t, ys[-1], fs[-1])
        # f_{k+1} still sees knots 0..k (``:193-202``): a violated lag reads
        # the newest knot whose derivative is written
        fs.append(f_eval(knots, k, t + h, y1))
        ys.append(y1)

    # sample the knots at the output times (``:227-234``)
    knots_y, knots_f = torch.stack(ys), torch.stack(fs)
    out = []
    for tq in t_host:
        pos = (tq - t0) / h
        i = int(np.clip(np.floor(pos), 0, n_steps - 1))
        s = float(np.clip(pos - i, 0.0, 1.0))
        out.append(_hermite(knots_y[i], knots_y[i + 1], knots_f[i], knots_f[i + 1], h, s))
    return format_solution(torch.stack(out), time_axis)
