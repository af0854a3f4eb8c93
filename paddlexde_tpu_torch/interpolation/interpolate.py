"""Differentiable spline interpolation over sampled series.

Counterpart of ``paddlexde_tpu/interpolation/interpolate.py``:
``LinearInterpolation`` / ``CubicHermiteSpline`` / ``BezierSpline`` over a
series ``[..., T, D]`` with knots ``t [T]``, exposing ``evaluate(t)`` and
``derivative(t)``. Evaluation is one vectorised segment lookup
(``searchsorted``) feeding a closed-form polynomial; gradients flow through
autograd. Hermite slopes are forward differences with the last slope
repeated; the Bezier family keeps the reference's sliding 4-point windows
normalised by the 3-knot span.
"""

from __future__ import annotations

import torch

from .._device import input_device, place

__all__ = [
    "InterpolationBase",
    "LinearInterpolation",
    "CubicHermiteSpline",
    "BezierSpline",
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
        t_eval = torch.as_tensor(t_eval, device=self._t.device).to(self._t.dtype)
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
