"""Log-signatures of piecewise-linear controls and the log-ODE method.

Counterpart of ``paddlexde_tpu/functional/logsig.py``:

- :func:`logsignature_windows`, the data transform (torchcde parity):
  depth-2 log-signatures of the piecewise-linear control over coarse
  windows, as a new series of channels ``[ΔX (C), the areas (C(C-1)/2)]``;
- :func:`cdeint_logode`, the log-ODE solver: per window the Lie-extended
  field

      F(y) = f(y)·ΔX + ½ Σ_ij [f_i, f_j](y)·A_ij + (1/3) Σ_ijk [f_i,[f_j,f_k]](y)·ℓ3_ijk

  is flowed for unit time. The brackets are ``torch.func.jvp`` of the matrix
  field (vmapped over the C columns), as the JAX form uses ``jax.jvp``; the
  1/3 is Dynkin's factor on the level-3 Lie element.

Within a segment a linear path has no area, so the window log-signature is
exact in closed form (cumulative sums and products over the segments).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..interpolation.interpolate import InterpolationBase, LinearInterpolation
from ..utils.misc import host_array, to_device
from .odeint import odeint
from .solve import format_solution

__all__ = ["logsignature_windows", "cdeint_logode", "piecewise_logsignature",
           "piecewise_logsignature3", "piecewise_signature3"]


def _outer(a, b):
    return a.unsqueeze(-1) * b.unsqueeze(-2)


def piecewise_logsignature(series, t=None):
    """Depth-2 log-signature of ONE window of a piecewise-linear path.

    Args:
        series: knots ``[..., m+1, C]`` (the window's path).
        t: unused (the log-signature is parameterisation-invariant).

    Returns:
        ``(increment [..., C], area [..., C, C])``: the level-1 term and the
        antisymmetric level-2 term ``A = ½Σ_{s<r}(δ_s⊗δ_r − δ_r⊗δ_s)``.
    """
    del t
    series = torch.as_tensor(series)
    deltas = torch.diff(series, dim=-2)  # [..., m, C]
    inc = deltas.sum(-2)
    prefix = torch.cumsum(deltas, dim=-2) - deltas  # exclusive prefix
    cross = torch.einsum("...si,...sj->...ij", prefix, deltas)
    return inc, 0.5 * (cross - cross.transpose(-1, -2))


def piecewise_signature3(series):
    """Levels 1-3 of the signature of one piecewise-linear window (exact,
    Chen's relation over the segments, each with its own signature
    ``(δ, δ⊗δ/2, δ⊗δ⊗δ/6)``): ``(S1 [..., C], S2 [..., C, C], S3 [..., C, C,
    C])``."""
    series = torch.as_tensor(series)
    deltas = torch.diff(series, dim=-2)  # [..., m, C]
    s1 = deltas.sum(-2)
    p1 = torch.cumsum(deltas, dim=-2) - deltas  # exclusive prefix of S1
    s2 = (torch.einsum("...si,...sj->...ij", p1, deltas)
          + 0.5 * torch.einsum("...si,...sj->...ij", deltas, deltas))
    seg_s2 = _outer(p1, deltas) + 0.5 * _outer(deltas, deltas)  # [..., m, C, C]
    p2 = torch.cumsum(seg_s2, dim=-3) - seg_s2
    s3 = (
        torch.einsum("...sij,...sk->...ijk", p2, deltas)
        + 0.5 * torch.einsum("...si,...sj,...sk->...ijk", p1, deltas, deltas)
        + (1.0 / 6.0) * torch.einsum("...si,...sj,...sk->...ijk", deltas, deltas, deltas)
    )
    return s1, s2, s3


def piecewise_logsignature3(series):
    """Depth-3 log-signature of one piecewise-linear window (exact):
    ``ℓ1 = S1``, ``ℓ2 = S2 − S1⊗S1/2``, ``ℓ3 = S3 − (S1⊗S2 + S2⊗S1)/2 +
    S1⊗S1⊗S1/3``."""
    s1, s2, s3 = piecewise_signature3(series)
    l2 = s2 - 0.5 * _outer(s1, s1)
    l3 = (
        s3
        - 0.5 * (torch.einsum("...i,...jk->...ijk", s1, s2)
                 + torch.einsum("...ij,...k->...ijk", s2, s1))
        + (1.0 / 3.0) * torch.einsum("...i,...j,...k->...ijk", s1, s1, s1)
    )
    return s1, l2, l3


def _vectorize_area(area):
    """Antisymmetric ``[..., C, C]`` -> strict upper triangle ``[...,
    C(C-1)/2]`` (row-major, i < j: the torchcde/signatory order)."""
    iu, ju = torch.triu_indices(area.shape[-1], area.shape[-1], offset=1, device=area.device)
    return area[..., iu, ju]


def logsignature_windows(series, t, *, window: Optional[float] = None,
                         knots_per_window: Optional[int] = None):
    """``(series, t)`` as depth-2 log-signature windows.

    Args:
        series: control knots ``[..., T, C]`` (piecewise-linear between).
        t: knot times ``[T]``.
        window: window length in time (knots binned by time), or
        knots_per_window: window length in knots; exactly one of the two.

    Returns:
        ``(logsig_series [..., n_windows+1, C + C(C-1)/2], t_windows
        [n_windows+1])``: the cumulative sum of the per-window ``[ΔX,
        vec(A)]`` with a zero first row, so its linear interpolation has the
        window log-signature as its per-window increment.
    """
    series = torch.as_tensor(series)
    t = torch.as_tensor(t)
    n_t = series.shape[-2]
    if (window is None) == (knots_per_window is None):
        raise ValueError("pass exactly one of window= or knots_per_window=")
    if knots_per_window is not None:
        k = int(knots_per_window)
        if k < 1:
            raise ValueError("knots_per_window must be >= 1")
        bounds = list(range(0, n_t - 1, k)) + [n_t - 1]
    else:
        t_host = host_array(t)
        edges = np.arange(float(t_host[0]), float(t_host[-1]), float(window))[1:]
        idx = np.searchsorted(t_host, edges)
        bounds = [0] + [int(i) for i in idx if 0 < int(i) < n_t - 1]
        bounds = sorted(set(bounds)) + [n_t - 1]
    incs, areas = [], []
    for a, b in zip(bounds[:-1], bounds[1:]):
        inc, area = piecewise_logsignature(series[..., a:b + 1, :])
        incs.append(inc)
        areas.append(_vectorize_area(area))
    per_window = torch.cat([torch.stack(incs, dim=-2), torch.stack(areas, dim=-2)], dim=-1)
    zero = torch.zeros_like(per_window[..., :1, :])
    logsig_series = torch.cat([zero, torch.cumsum(per_window, dim=-2)], dim=-2)
    return logsig_series, t[torch.as_tensor(bounds, device=t.device)]


def _lie_field(func, t_mid, inc, area, l3, depth):
    """The window's Lie-extended field ``y -> F(y)`` (JAX :270-319)."""

    def dmat(y_, v):  # ∂f/∂y(y_) · v -> [..., D, C]
        return torch.func.jvp(lambda yy: func(t_mid, yy), (y_,), (v,))[1]

    def cols_jvp(y_, mat_):  # [C(i), ..., D, C(j)]: ∂f_j · f_i
        return torch.func.vmap(lambda v: dmat(y_, v))(torch.movedim(mat_, -1, 0))

    def f_ext(y):
        mat = func(t_mid, y)  # [..., D, C]
        out = (mat * inc.unsqueeze(-2)).sum(-1)
        if depth == 1:
            return out
        d_all = cols_jvp(y, mat)
        # ½ Σ_ij [f_i, f_j]·A_ij = Σ_ij (∂f_j·f_i)·A_ij (A antisymmetric)
        out = out + (d_all * torch.movedim(area, -2, 0).unsqueeze(-2)).sum(-1).sum(0)
        if depth == 3:
            # F3 = (1/3) Σ_i (∂M_i·f_i − ∂f_i·M_i), M_i = Σ_jk ℓ3[ijk][f_j, f_k]
            def m_all(y_):
                da = cols_jvp(y_, func(t_mid, y_))  # da[j, ..., d, k] = ∂f_k·f_j
                # [f_j, f_k] = da[j,:,k] − da[k,:,j]
                first = torch.einsum("...ijk,...djk->...id", l3, torch.movedim(da, 0, -2))
                second = torch.einsum("...ijk,...djk->...id", l3, torch.movedim(da, 0, -1))
                return torch.movedim(first - second, -2, 0)  # [C(i), ..., D]

            m_i = m_all(y)
            cols = torch.movedim(mat, -1, 0)
            dm_fi = torch.func.vmap(lambda v: torch.func.jvp(m_all, (y,), (v,))[1])(cols)
            c = mat.shape[-1]
            idx = torch.arange(c, device=mat.device)
            dm_diag = dm_fi[idx, idx]  # [C, ..., D]
            df_mi = torch.func.vmap(lambda v: dmat(y, v))(m_i)  # [C, ..., D, C]
            df_diag = torch.movedim(torch.diagonal(df_mi, dim1=0, dim2=-1), -1, 0)
            out = out + (1.0 / 3.0) * torch.sum(dm_diag - df_diag, dim=0)
        return out

    return f_ext


def cdeint_logode(
    func,
    y0,
    t_span,
    control: Union[InterpolationBase, tuple],
    *,
    depth: int = 2,
    substeps: int = 1,
    solver: str = "rk4",
    time_axis: int = -2,
):
    """Solve the CDE ``dy = f(t, y)·dX`` by the depth-``depth`` log-ODE
    method over the intervals of ``t_span``: per interval the control's
    log-signature (closed form for a piecewise-linear X) and the
    Lie-extended field flowed for unit time with ``substeps`` steps of
    ``solver``. ``depth=1`` drops the brackets (exact for commuting
    fields); depth 3 costs C² nested jvp families per field evaluation.

    Args:
        func: ``func(t, y) -> [..., D_y, C]``, evaluated at the interval's
            midpoint time.
        control: an :class:`InterpolationBase` over X or a ``(series, t)``
            pair (linear interpolation: the convention the closed form is
            exact for).
        t_span: the window boundaries and output times (read on the host).

    Returns:
        the solution ``[..., T, D_y]`` on ``time_axis``.
    """
    if depth not in (1, 2, 3):
        raise ValueError(f"cdeint_logode supports depth 1, 2 or 3, got {depth}")
    if isinstance(control, InterpolationBase):
        interp = control
    else:
        interp = LinearInterpolation(*control)
    knots = host_array(interp._t)
    t_host = host_array(torch.as_tensor(t_span))
    tau = torch.linspace(0.0, 1.0, substeps + 1, dtype=torch.float64)

    def window_path(t_a, t_b):
        # exact for piecewise-linear X: the endpoints and the knots strictly
        # inside (JAX selects them by masking; they coincide)
        inside = knots[(knots > t_a) & (knots < t_b)]
        times = np.concatenate([[t_a], inside, [t_b]]).astype(knots.dtype)
        return interp.evaluate(to_device(times, interp._t.device))

    y, ys = y0, [y0]
    for t_a, t_b in zip(t_host[:-1], t_host[1:]):
        path = window_path(t_a, t_b)
        if depth == 3:
            inc, area, l3 = piecewise_logsignature3(path)
        else:
            (inc, area), l3 = piecewise_logsignature(path), None
        t_mid = torch.tensor(0.5 * (t_a + t_b), dtype=torch.float64)
        f_ext = _lie_field(func, t_mid, inc, area, l3, depth)
        y = odeint(lambda s, y_: f_ext(y_), y, tau, solver, time_axis=0)[-1]
        ys.append(y)
    return format_solution(torch.stack(ys, dim=0), time_axis)
