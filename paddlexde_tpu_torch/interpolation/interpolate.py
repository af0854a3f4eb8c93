"""Differentiable spline interpolation over sampled series.

Counterpart of ``paddlexde_tpu/interpolation/interpolate.py``:
``LinearInterpolation`` / ``CubicHermiteSpline`` / ``BezierSpline`` /
``NaturalCubicSpline`` over a series ``[..., T, D]`` with knots ``t [T]``,
exposing ``evaluate(t)`` and ``derivative(t)``, and
``rectilinear_interpolation``. Evaluation is one vectorised segment lookup
(``searchsorted``) feeding a closed-form polynomial; gradients flow through
autograd. Hermite slopes are forward differences with the last slope
repeated; the Bezier family keeps the reference's sliding 4-point windows
normalised by the 3-knot span.

A scalar host time (a Python number or a 0-dim CPU tensor, as the solvers
pass) becomes a fill on the knots' device, so that an evaluation against a
series on the card makes no host-device copy and no sync.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import input_device, place
from ..utils.misc import host_array

__all__ = [
    "InterpolationBase",
    "LinearInterpolation",
    "CubicHermiteSpline",
    "BezierSpline",
    "NaturalCubicSpline",
    "rectilinear_interpolation",
]


class InterpolationBase:
    """Shared machinery: knot bookkeeping + vectorised segment lookup."""

    def __init__(self, series, t=None):
        # tensors keep their device; a numpy/list series follows a tensor
        # ``t``, else goes to the card (raising without one)
        series = place(series, input_device(series, t))
        if t is None:
            t = torch.arange(series.shape[-2], dtype=series.dtype, device=series.device)
        t = torch.as_tensor(t, device=series.device).to(series.dtype).contiguous()
        if t.shape[0] != series.shape[-2]:
            raise ValueError(
                f"knots t [{t.shape[0]}] must match series time axis "
                f"[{series.shape[-2]}]"
            )
        self._series = series
        self._t = t

    @property
    def grid_points(self):
        return self._t

    @property
    def interval(self):
        return torch.stack([self._t[0], self._t[-1]])

    def _locate(self, t_eval):
        """Segment index + query times for each query (clamped)."""
        if (isinstance(t_eval, torch.Tensor) and t_eval.dim() == 0 and not t_eval.requires_grad
                and t_eval.device.type == "cpu" != self._t.device.type):
            t_eval = float(host_array(t_eval))
        if isinstance(t_eval, (int, float, np.floating, np.integer)):
            # a fill in the knots' dtype: no copy, and no rounding through
            # float32 first (JAX reads the number in the dtype)
            t_eval = torch.full((), float(t_eval), dtype=self._t.dtype, device=self._t.device)
        t_eval = torch.as_tensor(t_eval, dtype=self._t.dtype, device=self._t.device)
        scalar = t_eval.dim() == 0
        t_eval = torch.atleast_1d(t_eval)
        max_idx = self._series.shape[-2] - 2
        idx = (torch.searchsorted(self._t, t_eval.detach(), right=True) - 1).clamp(0, max_idx)
        return idx, t_eval, scalar

    def _gather(self, offset, idx):
        """series[..., idx + offset, :] with index clamping (last repeated)."""
        i = (idx + offset).clamp(0, self._series.shape[-2] - 1)
        return self._series.index_select(-2, i)

    def _knot(self, offset, idx):
        return self._t[(idx + offset).clamp(0, self._t.shape[0] - 1)]

    def evaluate(self, t):
        idx, t_eval, scalar = self._locate(t)
        out = self._evaluate(idx, t_eval)
        return out[..., 0, :] if scalar else out

    def derivative(self, t):
        idx, t_eval, scalar = self._locate(t)
        out = self._derivative(idx, t_eval)
        return out[..., 0, :] if scalar else out


def _exp(v, ref):
    """Broadcast a per-query vector [K] against [..., K, D] leaves."""
    return v[..., :, None].to(ref.dtype)


def _width(t0, t1):
    return torch.where(t1 == t0, torch.ones_like(t0), t1 - t0)


class LinearInterpolation(InterpolationBase):
    """Piecewise-linear interpolation."""

    def _coeffs(self, idx, t_eval):
        t0 = self._t[idx]
        h = _width(t0, self._knot(1, idx))
        x = (t_eval - t0) / h
        return self._gather(0, idx), self._gather(1, idx), x, h

    def _evaluate(self, idx, t_eval):
        p0, p1, x, _ = self._coeffs(idx, t_eval)
        return p0 + _exp(x, p0) * (p1 - p0)

    def _derivative(self, idx, t_eval):
        p0, p1, _, h = self._coeffs(idx, t_eval)
        return (p1 - p0) / _exp(h, p0)


class CubicHermiteSpline(InterpolationBase):
    """Cubic Hermite with forward-difference slopes."""

    def __init__(self, series, t=None):
        super().__init__(series, t)
        # slopes m_i = (p_{i+1} - p_i)/(t_{i+1} - t_i), last replicated
        dt = self._t[1:] - self._t[:-1]
        m = (self._series[..., 1:, :] - self._series[..., :-1, :]) / dt[:, None]
        self._m = torch.cat([m, m[..., -1:, :]], dim=-2)

    def _coeffs(self, idx, t_eval):
        t0 = self._t[idx]
        h = _width(t0, self._knot(1, idx))
        x = (t_eval - t0) / h
        p0, p1 = self._gather(0, idx), self._gather(1, idx)
        i1 = (idx + 1).clamp(0, self._m.shape[-2] - 1)
        m0 = self._m.index_select(-2, idx)
        m1 = self._m.index_select(-2, i1)
        return p0, p1, m0, m1, x, h

    def _evaluate(self, idx, t_eval):
        p0, p1, m0, m1, x, h = self._coeffs(idx, t_eval)
        x2 = x * x
        x3 = x2 * x
        h00 = 2 * x3 - 3 * x2 + 1
        h10 = x3 - 2 * x2 + x
        h01 = -2 * x3 + 3 * x2
        h11 = x3 - x2
        return (
            _exp(h00, p0) * p0
            + _exp(h10 * h, p0) * m0
            + _exp(h01, p0) * p1
            + _exp(h11 * h, p0) * m1
        )

    def _derivative(self, idx, t_eval):
        p0, p1, m0, m1, x, h = self._coeffs(idx, t_eval)
        x2 = x * x
        d00 = (6 * x2 - 6 * x) / h
        d10 = 3 * x2 - 4 * x + 1
        d01 = (-6 * x2 + 6 * x) / h
        d11 = 3 * x2 - 2 * x
        return (
            _exp(d00, p0) * p0
            + _exp(d10, p0) * m0
            + _exp(d01, p0) * p1
            + _exp(d11, p0) * m1
        )


class BezierSpline(InterpolationBase):
    """Cubic-Bezier smoothing over sliding 4-point windows (control points
    ``p_i..p_{i+3}``, last-clamped; local time normalised by the 3-knot span
    -- approximating, C0 at knots only)."""

    def _coeffs(self, idx, t_eval):
        t0 = self._t[idx]
        h = _width(t0, self._knot(3, idx))
        x = (t_eval - t0) / h
        return [self._gather(k, idx) for k in range(4)], x, h

    def _evaluate(self, idx, t_eval):
        (p0, p1, p2, p3), x, _ = self._coeffs(idx, t_eval)
        u = 1 - x
        b0 = u * u * u
        b1 = 3 * u * u * x
        b2 = 3 * u * x * x
        b3 = x * x * x
        return (
            _exp(b0, p0) * p0 + _exp(b1, p0) * p1 + _exp(b2, p0) * p2 + _exp(b3, p0) * p3
        )

    def _derivative(self, idx, t_eval):
        (p0, p1, p2, p3), x, h = self._coeffs(idx, t_eval)
        u = 1 - x
        d0 = 3 * u * u / h
        d1 = 3 * u * x / h
        d2 = 3 * x * x / h
        return (
            _exp(d0, p0) * (p1 - p0)
            + _exp(2 * d1, p0) * (p2 - p1)
            + _exp(d2, p0) * (p3 - p2)
        )


def _tridiagonal_solve(dl, dm, du, rhs):
    """Solve the tridiagonal system with sub-diagonal ``dl`` (``dl[0] =
    0``), main diagonal ``dm`` and super-diagonal ``du`` (``du[-1] = 0``),
    each [n], for the right-hand sides ``rhs`` [n, C] at once, by cyclic
    reduction: each level eliminates the even rows' neighbours from the odd
    rows (a system half the size), solves that, and back-substitutes the
    even rows. log2(n) levels of vectorised ops (~25 launches a level, ~300
    at 4096 knots) where a Thomas sweep would take O(n) sequential steps.
    Stable without pivoting for the diagonally dominant spline system.
    JAX calls ``jax.lax.linalg.tridiagonal_solve`` (LAPACK ``gtsv``); the
    two agree to rounding."""
    a, b, c, d = dl[:, None], dm[:, None], du[:, None], rhs
    n = b.shape[0]
    if n == 1:
        return d / b
    if n % 2 == 0:
        # a trailing identity row gives the last odd row its right neighbour
        one = torch.ones_like(b[:1])
        a, b, c = (torch.cat([a, 0 * one]), torch.cat([b, one]), torch.cat([c, 0 * one]))
        d = torch.cat([d, torch.zeros_like(d[:1])])
    a_e, b_e, c_e, d_e = a[0::2], b[0::2], c[0::2], d[0::2]
    a_o, b_o, c_o, d_o = a[1::2], b[1::2], c[1::2], d[1::2]
    alpha = -a_o / b_e[:-1]
    gamma = -c_o / b_e[1:]
    x_o = _tridiagonal_solve(
        (alpha * a_e[:-1])[:, 0],
        (b_o + alpha * c_e[:-1] + gamma * a_e[1:])[:, 0],
        (gamma * c_e[1:])[:, 0],
        d_o + alpha * d_e[:-1] + gamma * d_e[1:],
    )
    zero = torch.zeros_like(x_o[:1])
    x_e = (d_e - a_e * torch.cat([zero, x_o]) - c_e * torch.cat([x_o, zero])) / b_e
    # interleave even and odd rows, then drop the padding row
    x = torch.stack([x_e[:-1], x_o], dim=1).reshape(-1, d.shape[1])
    return torch.cat([x, x_e[-1:]])[:n]


class NaturalCubicSpline(InterpolationBase):
    """Natural cubic spline: C2-continuous interpolation (torchcde's
    canonical control path). The second derivatives M_i solve the
    tridiagonal system with natural ends (M_0 = M_{T-1} = 0) for all
    series columns at once (:func:`_tridiagonal_solve`, cyclic reduction);
    the piecewise cubic then evaluates and differentiates in closed form."""

    def __init__(self, series, t=None):
        super().__init__(series, t)
        series = self._series
        t = self._t
        n = t.shape[0]
        if n < 3:
            self._m2 = torch.zeros_like(series)
            return
        h = t[1:] - t[:-1]  # [n-1]
        x = series.reshape((-1,) + tuple(series.shape[-2:]))  # [B, T, D]
        c = x.transpose(0, 1).reshape(n, -1)  # [T, B*D], batch-major
        slope = (c[1:] - c[:-1]) / h[:, None]
        rhs = 6.0 * (slope[1:] - slope[:-1])  # [n-2, C]
        dl = h[:-1]
        dm = 2.0 * (h[:-1] + h[1:])
        du = h[1:]
        zero = torch.zeros_like(h[:1])
        m_inner = _tridiagonal_solve(torch.cat([zero, dl[1:]]), dm, torch.cat([du[:-1], zero]),
                                     rhs.to(dm.dtype))
        pad = torch.zeros_like(m_inner[:1])
        m_flat = torch.cat([pad, m_inner, pad], dim=0)
        m3 = m_flat.reshape((n, -1, series.shape[-1]))  # [T, B, D]
        self._m2 = m3.transpose(0, 1).reshape(series.shape).to(series.dtype)

    def _coeffs(self, idx, t_eval):
        t0 = self._t[idx]
        t1 = self._knot(1, idx)
        h = _width(t0, t1)
        i1 = (idx + 1).clamp(0, self._t.shape[0] - 1)
        p0, p1 = self._gather(0, idx), self._gather(1, idx)
        m0 = self._m2.index_select(-2, idx)
        m1 = self._m2.index_select(-2, i1)
        a = (t1 - t_eval) / h  # a + b = 1
        b = (t_eval - t0) / h
        return p0, p1, m0, m1, a, b, h

    def _evaluate(self, idx, t_eval):
        p0, p1, m0, m1, a, b, h = self._coeffs(idx, t_eval)
        return (
            _exp(a, p0) * p0
            + _exp(b, p0) * p1
            + _exp((a**3 - a) * h**2 / 6.0, p0) * m0
            + _exp((b**3 - b) * h**2 / 6.0, p0) * m1
        )

    def _derivative(self, idx, t_eval):
        p0, p1, m0, m1, a, b, h = self._coeffs(idx, t_eval)
        return (
            _exp(1.0 / h, p0) * (p1 - p0)
            + _exp(-(3 * a**2 - 1) * h / 6.0, p0) * m0
            + _exp((3 * b**2 - 1) * h / 6.0, p0) * m1
        )


def rectilinear_interpolation(series, t=None, *, time_channel: int = 0):
    """torchcde's causal interpolation for online prediction: the knots
    ``(t_i, x_i)`` become the doubled sequence ``(t_0, x_0) -> (t_1, x_0) ->
    (t_1, x_1) -> ...`` over a synthetic parameter (one unit a hop), time
    first and then value, so the control at ``s`` never looks ahead of the
    last observation; the ``time_channel`` carries the clock.

    Args:
        series: ``[..., T, C]`` with channel ``time_channel`` the observation
            time.
        t: observation times ``[T]`` (default: the time channel of the first
            batch element).

    Returns:
        ``(interp, s_knots)``: a :class:`LinearInterpolation` over the
        doubled sequence and its parameter knots ``[2T-1]``.
    """
    series = place(series, input_device(series, t))
    n_t = series.shape[-2]
    if t is None:
        t = series[..., time_channel].reshape((-1, n_t))[0]
    t = torch.as_tensor(t, device=series.device).to(series.dtype)
    # odd slot 2i+1 is (t_{i+1}, x_i): time advances, value held
    held = series[..., :-1, :]
    t_next = t[1:][:, None].expand(tuple(held.shape[:-1]) + (1,))
    x_odd = torch.cat([held[..., :time_channel], t_next, held[..., time_channel + 1:]], dim=-1)
    pairs = torch.stack([series[..., :-1, :], x_odd], dim=-2)  # [..., T-1, 2, C]
    doubled = torch.cat([pairs.reshape(tuple(series.shape[:-2]) + (2 * (n_t - 1), -1)),
                         series[..., -1:, :]], dim=-2)
    s_knots = torch.arange(2 * n_t - 1, dtype=series.dtype, device=series.device)
    return LinearInterpolation(doubled, s_knots), s_knots
