"""cdeint: neural controlled differential equations.

Counterpart of ``paddlexde_tpu/functional/cdeint.py``, torchcde semantics:

    dy/dt = f(t, y) @ dX/dt,   X = the interpolated control path,

so irregular series enter through the interpolation's ``derivative()``
and the solve is a plain ODE: every solver of ``odeint`` applies, and
``adjoint=True`` runs :func:`~.odeint_adjoint.odeint_adjoint`. A ``(series,
t)`` control becomes a :class:`CubicHermiteSpline`.

The one difference from the JAX function: JAX finds the arrays the field
closes over by ``closure_convert``, which PyTorch cannot do, so the adjoint
takes ``adjoint_params`` (default ``func.parameters()`` for an
``nn.Module``, else none), as ``ddeint_adjoint`` does, and appends the
control's own tensors whenever they need a gradient.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..interpolation.interpolate import CubicHermiteSpline, InterpolationBase
from ..xde.term import cde_term
from .odeint_adjoint import odeint_adjoint
from .solve import integrate_term

__all__ = ["cdeint"]


def _control(control: Union[InterpolationBase, tuple]) -> InterpolationBase:
    if isinstance(control, InterpolationBase):
        return control
    series, t = control
    return CubicHermiteSpline(series, t)


def cdeint(
    func,
    y0,
    t_span,
    control,
    solver="dopri5",
    *,
    rtol=1e-7,
    atol=1e-9,
    options: Optional[dict] = None,
    adjoint: bool = False,
    time_axis: int = -2,
    **adjoint_kwargs,
):
    """Integrate a neural CDE.

    Args:
        func: matrix-valued field ``func(t, y) -> [..., D_y, D_x]``.
        y0: initial latent state ``[..., D_y]``.
        t_span: output times.
        control: an :class:`InterpolationBase` over the control path X, or a
            ``(series, t)`` pair (a cubic Hermite spline).
        adjoint: O(1)-memory adjoint gradients; ``adjoint_kwargs`` go to
            ``odeint_adjoint`` (``adjoint_params``, ``adjoint_solver``, ...).
    """
    interp = _control(control)

    def d_x(t):
        # a scalar query gives [..., D_x]
        return interp.derivative(t.reshape(()) if isinstance(t, torch.Tensor) else t)

    if adjoint:
        def f_eff(t, y):
            return (func(t, y) @ d_x(t).unsqueeze(-1)).squeeze(-1)

        params = adjoint_kwargs.pop("adjoint_params", None)
        if params is None:
            params = func.parameters() if isinstance(func, torch.nn.Module) else ()
        params = list(params) + [v for v in vars(interp).values()
                                 if isinstance(v, torch.Tensor) and v.requires_grad]
        return odeint_adjoint(
            f_eff, y0, t_span, solver, rtol=rtol, atol=atol, options=options,
            time_axis=time_axis, adjoint_params=params, **adjoint_kwargs,
        )

    return integrate_term(
        cde_term(func, d_x), y0, t_span, solver, rtol=rtol, atol=atol, options=options,
        time_axis=time_axis,
    )
