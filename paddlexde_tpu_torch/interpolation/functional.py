"""Stateless 2-point interpolation formulas and missing-data filling.

Counterpart of ``paddlexde_tpu/interpolation/functional.py``: the forms
solvers use for per-step dense output (``t`` a scalar or size-1 time;
states are trees, returned with the same structure), and
:func:`fill_forward`, whose time scan becomes a cumulative index: the last
observed position at or before each time (``cummax``), then one gather.
"""

from __future__ import annotations

import torch
from torch.utils._pytree import tree_map

from .._device import input_device, place

__all__ = ["linear_interp", "cubic_hermite_interp", "fill_forward"]


def _scalar(t):
    return torch.as_tensor(t).reshape(())


def linear_interp(t0, t1, y0, y1, t):
    """Linear between (t0, y0) and (t1, y1), evaluated at scalar t."""
    t0, t1, t = _scalar(t0), _scalar(t1), _scalar(t)
    denom = torch.where(t1 == t0, torch.ones_like(t0), t1 - t0)
    w = torch.where(t1 == t0, torch.zeros_like(t0), (t - t0) / denom)
    return tree_map(lambda a, b: a + w.to(a.dtype) * (b - a), y0, y1)


def cubic_hermite_interp(t0, y0, dy0, t1, y1, dy1, t):
    """Cubic Hermite between endpoints with derivatives, at scalar t."""
    t0, t1, t = _scalar(t0), _scalar(t1), _scalar(t)
    h = torch.where(t1 == t0, torch.ones_like(t0), t1 - t0)
    x = torch.where(t1 == t0, torch.zeros_like(t0), (t - t0) / h)
    h00 = (1 + 2 * x) * (1 - x) ** 2
    h10 = x * (1 - x) ** 2
    h01 = x**2 * (3 - 2 * x)
    h11 = x**2 * (x - 1)

    def leaf(a, da, b, db):
        c = lambda v: v.to(a.dtype)  # noqa: E731
        return c(h00) * a + c(h10 * h) * da + c(h01) * b + c(h11 * h) * db

    return tree_map(leaf, y0, dy0, y1, dy1)


def fill_forward(series, mask=None):
    """Missing-data preprocessing for CDE control paths (torchcde-style):
    NaN observations (or entries where ``mask`` is False) take the last
    observed value along the time axis (axis -2); leading missing values
    take the first observation (an entry never observed keeps its first
    value). Append an observation-mask channel to let the CDE see
    observation times."""
    series = place(series, input_device(series, mask))
    if mask is None:
        observed = ~torch.isnan(series)
    else:
        observed = torch.as_tensor(mask, device=series.device).to(torch.bool).expand(series.shape)
    t_axis = series.dim() - 2
    n_t = series.shape[t_axis]
    pos = torch.arange(n_t, device=series.device).reshape((n_t, 1))
    last = torch.where(observed, pos, -1).cummax(dim=t_axis).values
    # before the first observation: the first observation (argmax of the
    # mask; 0 where there is none)
    first = observed.to(torch.uint8).argmax(dim=t_axis, keepdim=True)
    idx = torch.where(last < 0, first, last)
    return torch.gather(series, t_axis, idx)
