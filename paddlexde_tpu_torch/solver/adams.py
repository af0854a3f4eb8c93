"""Adams-Bashforth(-Moulton) multistep solver, orders 4-12.

Counterpart of ``paddlexde_tpu/solver/adams.py``. The first three steps
bootstrap with RK4 and fill a ring of past derivative evaluations (newest
first); every later step takes the Adams-Bashforth predictor of order
``min(step + 1, max_order)`` -- a host integer, since it depends on the
step count only -- and, with ``implicit``, the Adams-Moulton corrector: a
fixed trip of ``max_iters`` functional iterations where an iteration after
convergence (error ratio of the update below 1) leaves the state as it is,
selected by ``torch.where`` as the JAX package's ``fori_loop`` does, so a
step makes no device-to-host read.

The tables assume a uniform grid: pass ``step_size`` when ``t_span`` is
not uniform.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_map

from ..utils.misc import host_array
from ..utils.norms import rms_norm
from ..utils.ode_utils import compute_error_ratio
from ..xde.term import XDETerm
from .fixed import _linear, make_grid, rk4_step

__all__ = ["solve_adams"]

# Integer coefficient tables of Adams-Bashforth(-Moulton), orders 1..12
# (Hairer-Norsett-Wanner), the JAX package's copy with its two data
# corrections of the reference's tables: divisor[1] is 1 (order-1 AB is
# Euler) and _BASHFORTH[12][10] is 3158642445 (the reference row does not
# sum to its divisor).
_BASHFORTH = [
    [],
    [1],
    [3, -1],
    [23, -16, 5],
    [55, -59, 37, -9],
    [1901, -2774, 2616, -1274, 251],
    [4277, -7923, 9982, -7298, 2877, -475],
    [198721, -447288, 705549, -688256, 407139, -134472, 19087],
    [434241, -1152169, 2183877, -2664477, 2102243, -1041723, 295767, -36799],
    [14097247, -43125206, 95476786, -139855262, 137968480, -91172642, 38833486, -9664106, 1070017],
    [30277247, -104995189, 265932680, -454661776, 538363838, -444772162, 252618224, -94307320, 20884811, -2082753],
    [2132509567, -8271795124, 23591063805, -46113029016, 63716378958, -63176201472, 44857168434, -22329634920, 7417904451, -1479574348, 134211265],
    [4527766399, -19433810163, 61633227185, -135579356757, 214139355366, -247741639374, 211103573298, -131365867290, 58189107627, -17410248271, 3158642445, -262747265],
]
_MOULTON = [
    [],
    [1],
    [1, 1],
    [5, 8, -1],
    [9, 19, -5, 1],
    [251, 646, -264, 106, -19],
    [475, 1427, -798, 482, -173, 27],
    [19087, 65112, -46461, 37504, -20211, 6312, -863],
    [36799, 139849, -121797, 123133, -88547, 41499, -11351, 1375],
    [1070017, 4467094, -4604594, 5595358, -5033120, 3146338, -1291214, 312874, -33953],
    [2082753, 9449717, -11271304, 16002320, -17283646, 13510082, -7394032, 2687864, -583435, 57281],
    [134211265, 656185652, -890175549, 1446205080, -1823311566, 1710774528, -1170597042, 567450984, -184776195, 36284876, -3250433],
    [262747265, 1374799219, -2092490673, 3828828885, -5519460582, 6043521486, -4963166514, 3007739418, -1305971115, 384709327, -68928781, 5675265],
]
_DIVISOR = [None, 1, 2, 12, 24, 720, 1440, 60480, 120960, 3628800, 7257600, 479001600, 958003200]

_MAX_ORDER = 12


def _padded_table(rows, max_order: int) -> np.ndarray:
    """[max_order + 1, max_order] coefficients, one row per order (float64)."""
    out = np.zeros((max_order + 1, max_order), np.float64)
    for order in range(1, max_order + 1):
        row = rows[order]
        out[order, : len(row)] = np.asarray(row, np.float64) / float(_DIVISOR[order])
    return out


def _weighted(hist, coeffs):
    """``sum_j coeffs[j] * hist[j]`` per leaf (history on the leading axis)."""
    return tree_map(lambda h: torch.tensordot(coeffs.to(h.dtype), h, dims=([0], [0])), hist)


def solve_adams(
    term: XDETerm,
    y0,
    t_span,
    *,
    rtol=1e-3,
    atol=1e-4,
    implicit: bool = False,
    max_iters: int = 4,
    max_order: Optional[int] = None,
    step_size=None,
    grid_constructor: Optional[Callable] = None,
    grid=None,
    norm: Callable = rms_norm,
    time_dtype=None,
):
    """Integrate with AB(M); returns a time-first ``[T, ...]`` tree.

    Default ``max_order``: 4 for explicit AB (higher orders have vanishing
    stability regions), 12 with the implicit corrector."""
    if max_order is None:
        max_order = _MAX_ORDER if implicit else 4
    max_order = int(np.clip(max_order, 4, _MAX_ORDER))
    t_span = torch.as_tensor(t_span)
    if time_dtype is not None:
        t_span = t_span.to(time_dtype)
    grid_is_tspan = step_size is None and grid_constructor is None and grid is None
    grid = make_grid(t_span, step_size=step_size, grid_constructor=grid_constructor,
                     grid=grid).to(t_span.dtype)
    n_nodes = grid.shape[0]
    device = grid.device
    bash = torch.as_tensor(_padded_table(_BASHFORTH, max_order), device=device)
    moul = torch.as_tensor(_padded_table(_MOULTON, max_order), device=device)

    def push(hist, f):
        """The ring's newest derivative goes to index 0."""
        return tree_map(lambda h, fl: torch.cat([fl[None].to(h.dtype), h[:-1]]), hist, f)

    hist = tree_map(lambda yl: torch.zeros((max_order,) + yl.shape, dtype=yl.dtype,
                                           device=yl.device), y0)
    n_boot = min(3, n_nodes - 1)
    y, ys = y0, [y0]
    for i in range(n_boot):
        t0, t1 = grid[i], grid[i + 1]
        hist = push(hist, term.move(t0, t1 - t0, y))
        y, _ = rk4_step(term, t0, t1, y)
        ys.append(y)

    for i in range(n_boot, n_nodes - 1):
        order = min(i + 1, max_order)
        t0, t1 = grid[i], grid[i + 1]
        dt = t1 - t0
        hist = push(hist, term.move(t0, dt, y))
        y_pred = tree_map(lambda yl, wl: yl + dt.to(yl.dtype) * wl, y, _weighted(hist, bash[order]))
        if implicit:
            m_row = moul[order]
            # m_row[0] weighs f_{n+1}; m_row[1:] the ring (f_n, f_{n-1}, ...)
            hist_part = _weighted(hist, torch.cat([m_row[1:], m_row.new_zeros(1)]))
            c0 = m_row[0]
            y_cur, converged = y_pred, torch.zeros((), dtype=torch.bool, device=device)
            for _ in range(max_iters):
                f_new = term.move(t1, dt, y_cur)
                y_next = tree_map(
                    lambda yl, hp, fn: yl + dt.to(yl.dtype) * (hp + c0.to(yl.dtype) * fn),
                    y, hist_part, f_new)
                delta = tree_map(torch.sub, y_next, y_cur)
                ratio = compute_error_ratio(delta, rtol, atol, y_cur, y_next, norm)
                y_cur = tree_map(lambda a, b: torch.where(converged, a, b), y_cur, y_next)
                converged = converged | (ratio < 1.0)
            y = y_cur
        else:
            y = y_pred
        ys.append(y)

    ys_nodes = tree_map(lambda *ls: torch.stack(ls), *ys)
    if grid_is_tspan:
        return ys_nodes
    # dense output on a step_size grid: linear between nodes
    first, last = host_array(grid[[0, -1]]).tolist()
    direction = 1.0 if last >= first else -1.0
    idx = (torch.searchsorted((direction * grid).contiguous(), (direction * t_span).contiguous(),
                              right=True) - 1).clamp(0, n_nodes - 2)

    def gather(tree, i):
        return tree_map(lambda a: a[i], tree)

    return _linear(grid[idx], gather(ys_nodes, idx), grid[idx + 1], gather(ys_nodes, idx + 1),
                   t_span)
