"""Shared pieces of the SDE scheme zoo: the Euler-Maruyama term, the
time-reversal drift corrections, and the helpers several schemes share
(general-noise fuse, cubic-path coefficients, the RK4 theta integrator).

Counterpart of ``paddlexde_tpu/functional/sde_schemes/common.py``. States
are single tensors (``sdeint``'s contract); ``jax.jvp``/``jax.linearize``
become ``torch.func.jvp`` (vmapped over the noise columns where JAX vmaps),
so a diffusion must be ``torch.func``-transformable (no ``.item()``).
Matrix-vector contractions are written as products and sums, never a
matmul: on the card a float32 matmul may take TF32, which would swamp the
schemes' error floors (JAX asks for ``Precision.HIGHEST`` for the same
reason).
"""

from __future__ import annotations

import numpy as np
import torch

from ...brownian.api import ReverseBrownian
from ...xde.term import XDETerm

__all__ = ["make_sde_term", "noise_drift_correction"]


def _general_fuse(dy, dt, y):
    """y + f dt + the noise term: the fuse of every scheme whose ``move``
    returns the pair ``(f, noise)``."""
    f_val, g_dw = dy
    return y + dt * f_val + g_dw


def _mv(g, z):
    """``einsum("...dm,...m->...d", g, z)`` as a product and a sum."""
    return (g * z.unsqueeze(-2)).sum(-1)


# cubic-path coefficient map: (a, b, c) of q(θ)=aθ³+bθ²+cθ from the moment
# constraints q(1)=ŵ, ∫₀¹q=û, ∫₀¹(1-θ)q=k̂ (scaled w, u/h, k/h²); constant
# 3x3 inverse computed once in f64
_CUBIC_MINV = np.linalg.inv(np.array(
    [[1.0, 1.0, 1.0],
     [1.0 / 4.0, 1.0 / 3.0, 1.0 / 2.0],
     [1.0 / 20.0, 1.0 / 12.0, 1.0 / 6.0]]
))


def _cubic_path_coeffs(w, u, k, dt):
    """(a, b, c) of the unique cubic q(θ) on [0, 1] matching the step's
    (W, I10, K) triple. q' is quadratic, so RK4's Simpson weights integrate
    the noise path segment exactly for constant diffusion."""
    safe = torch.where(dt == 0, torch.ones_like(dt), dt)

    def row(r):
        return r[0] * w + r[1] * (u / safe) + r[2] * (k / safe**2)

    return tuple(row(tuple(float(x) for x in _CUBIC_MINV[i])) for i in range(3))


def _rk4_theta(F, y, substeps: int):
    """Classic RK4 over θ ∈ [0, 1] in ``substeps`` equal substeps."""
    dth = 1.0 / substeps
    for i in range(substeps):
        th = i * dth
        k1 = F(th, y)
        k2 = F(th + 0.5 * dth, y + 0.5 * dth * k1)
        k3 = F(th + 0.5 * dth, y + 0.5 * dth * k2)
        k4 = F(th + dth, y + dth * k3)
        y = y + (dth / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    return y


def _columns_jvp(fn, y, tangents):
    """``∂fn/∂y · v`` for each ``v`` along the leading axis of ``tangents``
    (JAX's ``vmap`` of ``jvp``)."""
    return torch.func.vmap(lambda v: torch.func.jvp(fn, (y,), (v,))[1])(tangents)


def noise_drift_correction(diffusion, noise: str = "diagonal"):
    """The Itô correction field ``Σ_j (∂G_{·j}/∂y)·G_{·j}`` as ``corr(t, y)``
    for each noise contract: the one kernel behind time reversal
    (coefficient +1) and the Itô-Stratonovich converters (∓½,
    ``functional/calculus.py``). 'diagonal': the elementwise ``g·∂g/∂y`` by
    a jvp with ones (exact for diagonal Jacobians); 'scalar': the
    directional ``(∂g/∂y)·g``; 'general': the column trace of the matrix
    G's jvps."""
    if noise not in ("diagonal", "scalar", "general"):
        raise ValueError(
            f"noise must be 'diagonal', 'scalar' or 'general', got {noise!r}"
        )

    def corr(t, y):
        fn = lambda y_: diffusion(t, y_)  # noqa: E731
        if noise == "general":
            g_val = fn(y)
            dg_all = _columns_jvp(fn, y, torch.movedim(g_val, -1, 0))  # [M, ..., D, M]
            return torch.diagonal(dg_all, dim1=0, dim2=-1).sum(-1)
        if noise == "scalar":
            g_val = fn(y)
            return torch.func.jvp(fn, (y,), (g_val,))[1]
        g_val, dg = torch.func.jvp(fn, (y,), (torch.ones_like(y),))
        return g_val * dg

    return corr


def _reversed_ito_fns(drift, diffusion, bm):
    """Time reversal (s = -t) of an Itô SDE with diagonal noise: the drift
    gains ``+g·∂g/∂y`` (the backward Itô integral's endpoint convention),
    and the reversed system is itself an Itô SDE."""
    corr = noise_drift_correction(diffusion, "diagonal")

    def drift_rev(s, y):
        t = -s
        return -drift(t, y) + corr(t, y)

    return drift_rev, (lambda s, y: diffusion(-s, y)), ReverseBrownian(bm)


def _reversed_scalar_ito_fns(drift, diffusion, bm):
    """Time reversal of a SCALAR-noise Itô SDE: the correction is the
    directional ``(∂g/∂y)·g``."""
    corr = noise_drift_correction(diffusion, "scalar")

    def drift_rev(s, y):
        t = -s
        return -drift(t, y) + corr(t, y)

    return drift_rev, (lambda s, y: diffusion(-s, y)), ReverseBrownian(bm)


def _reversed_general_ito_fns(drift, diffusion, bm):
    """Time reversal of a GENERAL (matrix) noise Itô SDE: ``f~(s, y) =
    -f(-s, y) + Σ_j (∂G_{·j}/∂y)·G_{·j}(-s, y)``."""
    corr = noise_drift_correction(diffusion, "general")

    def drift_rev(s, y):
        t = -s
        return -drift(t, y) + corr(t, y)

    return drift_rev, (lambda s, y: diffusion(-s, y)), ReverseBrownian(bm)


def _reversed_stratonovich_fns(drift, diffusion, bm):
    """Time reversal of a STRATONOVICH SDE: no drift correction (the
    calculus is time-symmetric); negate the drift and retrace the path."""
    return (
        (lambda s, y: -drift(-s, y)),
        (lambda s, y: diffusion(-s, y)),
        ReverseBrownian(bm),
    )


def make_sde_term(drift, diffusion, bm, *, reverse: bool = False) -> XDETerm:
    """The Euler-Maruyama term; with ``reverse``, drift, diffusion and noise
    are the substituted-time (s = -t) forms."""
    if reverse:
        drift, diffusion, bm = _reversed_ito_fns(drift, diffusion, bm)

    def move(t, dt, y):
        d_w = bm(t, t + dt)
        return (drift(t, y), diffusion(t, y) * d_w)

    return XDETerm(move=move, fuse=_general_fuse, additive=False, kind="sde")
