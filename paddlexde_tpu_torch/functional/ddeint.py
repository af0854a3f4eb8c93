"""ddeint: delay differential equations with learnable fractional lags.

Counterpart of ``paddlexde_tpu/functional/ddeint.py``, same signature and
the same ``(solution, y_lags)`` return: the history is evaluated at the lags
once before integration (gradients reach the lags, not the history), the
damping is folded into the field, and the fixed-grid engine integrates.

Accepted ``func`` signatures: ``func(y_lags, y)`` (D3STN),
``func(t, y, lags, y_lags)`` and ``func(t, y, *, lags, y_lags)``.
"""

from __future__ import annotations

from typing import Optional

from torch.utils._pytree import tree_leaves, tree_map

from .._device import input_device, place
from ..xde.history import history_index
from ..xde.term import dde_term
from .solve import integrate_term

__all__ = ["ddeint"]


def ddeint(
    func,
    y0,
    t_span,
    lags,
    his,
    his_span,
    solver="euler",
    his_processed: bool = False,
    rtol=1e-7,
    atol=1e-9,
    options: Optional[dict] = None,
    fixed_solver_interp: str = "linear",
    *,
    interpolation: str = "cubic",
    damping: float = 1e-3,
    time_axis: int = -2,
):
    """Integrate a delay DE; returns ``(solution, y_lags)``.

    ``his_processed=True`` takes ``lags`` as the already evaluated history.
    Tensors keep their device; numpy/list data follows the first tensor
    among ``his``, ``lags`` and ``y0``, else goes to the card. A host
    ``t_span`` keeps the solve free of device-to-host syncs.
    """
    device = input_device(his, lags, *tree_leaves(y0))
    y0 = tree_map(lambda a: place(a, device), y0)
    if his_processed:
        y_lags = place(lags, device)
    else:
        y_lags = history_index(lags, place(his, device), his_span, interpolation=interpolation)

    term = dde_term(func, lags, y_lags, damping=damping)
    solution = integrate_term(
        term,
        y0,
        t_span,
        solver,
        rtol=rtol,
        atol=atol,
        options=options,
        time_axis=time_axis,
        interp=fixed_solver_interp,
    )
    return solution, y_lags
