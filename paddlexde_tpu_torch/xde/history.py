"""Differentiable history lookup at learnable fractional lags.

Counterpart of ``paddlexde_tpu/xde/history.py``: evaluate a spline over the
history series at (learnable, fractional) lag positions, with gradients
flowing to the lags only by default -- the delay-selection mechanism that
lets D3STN learn where in a long history to look.

The cubic path on a CUDA tensor runs the fused gather+Hermite kernel
(``ops/spline.py``, whose backward gives the lag gradient); everything else
is the interpolation classes under autograd.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from .._device import input_device, place
from ..interpolation.interpolate import (
    BezierSpline,
    CubicHermiteSpline,
    LinearInterpolation,
)

__all__ = ["history_index", "HistoryIndex"]

_INTERPS = {
    "linear": LinearInterpolation,
    "cubic": CubicHermiteSpline,
    "cubic_hermite": CubicHermiteSpline,
    "bezier": BezierSpline,
}


def history_index(
    lags,
    his,
    his_span=None,
    *,
    interpolation: Union[str, type] = "cubic",
    stop_his_gradient: bool = True,
    use_kernel: Optional[bool] = None,
):
    """Evaluate the history ``his [..., T, D]`` at fractional ``lags [L]``.

    Returns ``y_lags [..., L, D]``. Gradients flow to ``lags`` (and to ``his``
    too when ``stop_his_gradient=False``).

    ``use_kernel``: route the cubic path through the fused spline kernel.
    ``None`` (default): on whenever ``his`` lies on a CUDA device and
    gradients to ``his`` are off; ``False``: the spline class on any device;
    ``True``: the kernel (``his`` must be a CUDA tensor).

    Tensors keep their device; a numpy/list ``his`` goes to the device of
    ``lags`` when that is a tensor, else to the card (raising without one).
    """
    his = place(his, input_device(his, lags))
    if stop_his_gradient:
        his = his.detach()
    lags = torch.as_tensor(lags, device=his.device)

    if interpolation in ("cubic", "cubic_hermite"):
        if use_kernel is None:
            use_kernel = stop_his_gradient and his.is_cuda
        if use_kernel:
            if not his.is_cuda:
                raise ValueError("use_kernel=True needs a CUDA history tensor")
            if not stop_his_gradient:
                raise ValueError("the spline kernel gives no gradient to the history")
            from ..ops.spline import hermite_gather_eval

            span = (
                torch.arange(his.shape[-2], dtype=his.dtype, device=his.device)
                if his_span is None
                else his_span
            )
            return hermite_gather_eval(his, span, lags)
    elif use_kernel:
        raise ValueError(f"the spline kernel is cubic only, not {interpolation!r}")

    cls = _INTERPS[interpolation] if isinstance(interpolation, str) else interpolation
    return cls(his, his_span).evaluate(lags)


class HistoryIndex:
    """Reference-parity alias: ``HistoryIndex.apply(lags, his, his_span)``."""

    @staticmethod
    def apply(lags, his, his_span=None, interpolation="cubic"):
        return history_index(lags, his, his_span, interpolation=interpolation)
