"""Itô <-> Stratonovich drift conversion.

Counterpart of ``paddlexde_tpu/functional/calculus.py``:

    f_strat = f_ito - ½ Σ_j (∂G_{·j}/∂y)·G_{·j}        (and + for the inverse)

(for diagonal noise the elementwise ½·g·∂g/∂y). The correction is
:func:`~.sde_schemes.common.noise_drift_correction`: forward-mode
derivatives of the diffusion by ``torch.func.jvp``.
"""

from __future__ import annotations

from .sde_schemes.common import noise_drift_correction

__all__ = ["ito_to_stratonovich", "stratonovich_to_ito"]


def ito_to_stratonovich(drift, diffusion, *, noise: str = "diagonal"):
    """The STRATONOVICH drift of the Itô SDE ``(drift, diffusion)``: solve
    ``(f_strat, diffusion)`` with ``heun_stratonovich`` for the process the
    Itô pair describes under euler/milstein/...

    Args:
        noise: 'diagonal' (g like y, diagonal Jacobian), 'scalar' (one
            channel, coupled g) or 'general' (matrix ``G -> [..., D, M]``).
    """
    corr = noise_drift_correction(diffusion, noise)

    def f_strat(t, y):
        return drift(t, y) - 0.5 * corr(t, y)

    return f_strat


def stratonovich_to_ito(drift, diffusion, *, noise: str = "diagonal"):
    """The ITÔ drift of the Stratonovich SDE ``(drift, diffusion)`` (the +½
    direction of :func:`ito_to_stratonovich`)."""
    corr = noise_drift_correction(diffusion, noise)

    def f_ito(t, y):
        return drift(t, y) + 0.5 * corr(t, y)

    return f_ito
