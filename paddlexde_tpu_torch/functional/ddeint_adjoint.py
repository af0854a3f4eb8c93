"""ddeint_adjoint: O(1)-memory gradients for the delay-DE path.

Counterpart of ``paddlexde_tpu/functional/ddeint_adjoint.py:32-89``, same
signature and the same ``(solution, y_lags)`` return. With the history
lookup evaluated once before integration (as :func:`ddeint` does), the DDE
is an ODE in ``y`` whose field closes over ``y_lags``; the damping is folded
into the field leafwise (``f_eff = f - damping * y``, which coincides with
the fixed-Euler forward of :func:`ddeint`), and
:func:`~paddlexde_tpu_torch.functional.odeint_adjoint.odeint_adjoint`
integrates it. The lookup sits outside the adjoint: the lag gradient flows
from ``y_lags``'s cotangent by ordinary autograd (on the card through the
history kernel's lag-gradient kernel).

The one difference from the JAX function: JAX lifts ``y_lags`` out of the
field's closure by ``closure_convert``, which PyTorch cannot do, and
``odeint_adjoint`` gives no gradient to a closed-over tensor that is missing
from its ``adjoint_params``. So ``ddeint_adjoint`` takes ``adjoint_params``
(default ``func.parameters()`` for an ``nn.Module``, else none) and always
appends ``y_lags`` when it needs a gradient; without that the lag gradient
would vanish silently.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils._pytree import tree_leaves, tree_map

from .._device import input_device, place
from ..xde.history import history_index
from ..xde.term import _dde_call
from .odeint_adjoint import odeint_adjoint

__all__ = ["ddeint_adjoint"]


def ddeint_adjoint(
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
    interpolation="cubic",
    damping: float = 1e-3,
    time_axis: int = -2,
    adjoint_solver=None,
    adjoint_rtol=None,
    adjoint_atol=None,
    adjoint_options: Optional[dict] = None,
    adjoint_params=None,
):
    """Like :func:`~paddlexde_tpu_torch.functional.ddeint.ddeint` but with
    adjoint gradients; returns ``(solution, y_lags)``.

    ``adjoint_params``: the tensors ``func`` closes over that need a
    gradient (default: ``func.parameters()`` for an ``nn.Module``, else
    none); ``y_lags`` is added to them whenever it requires a gradient.
    Tensors keep their device; numpy/list data follows the first tensor
    among ``his``, ``lags`` and ``y0``, else goes to the card.
    """
    device = input_device(his, lags, *tree_leaves(y0))
    y0 = tree_map(lambda a: place(a, device), y0)
    if his_processed:
        y_lags = place(lags, device)
    else:
        y_lags = history_index(lags, place(his, device), his_span, interpolation=interpolation)

    call = _dde_call(func)

    def f_eff(t, y):
        dy = call(t, y, lags, y_lags)
        if not damping:
            return dy
        return tree_map(lambda d, yl: d - damping * yl, dy, y)

    if adjoint_params is None:
        adjoint_params = func.parameters() if isinstance(func, torch.nn.Module) else ()
    params = list(adjoint_params)
    if y_lags.requires_grad:
        params.append(y_lags)

    solution = odeint_adjoint(
        f_eff,
        y0,
        t_span,
        solver,
        rtol=rtol,
        atol=atol,
        options={**(options or {}), "interp": fixed_solver_interp}
        if fixed_solver_interp
        else options,
        adjoint_solver=adjoint_solver,
        adjoint_rtol=adjoint_rtol,
        adjoint_atol=adjoint_atol,
        adjoint_options=adjoint_options,
        adjoint_params=params,
        time_axis=time_axis,
    )
    return solution, y_lags
