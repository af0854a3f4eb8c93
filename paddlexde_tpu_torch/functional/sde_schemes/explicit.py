"""Explicit pathwise SDE schemes (diagonal and matrix noise).

Counterpart of ``paddlexde_tpu/functional/sde_schemes/explicit.py``: the
same updates, step for step, on single-tensor states (module docstring of
:mod:`.common` for the jvps and the contractions).
"""

from __future__ import annotations

import torch

from ...xde.term import XDETerm
from .common import _cubic_path_coeffs, _general_fuse, _mv, _rk4_theta


def _safe(dt):
    return torch.where(dt == 0, torch.ones_like(dt), dt)


def make_milstein_term(drift, diffusion, bm) -> XDETerm:
    """Milstein for diagonal Itô noise, strong order 1.0:

        y1 = y + f dt + g dW + 1/2 g (dg/dy) (dW^2 - dt)

    ``dg/dy`` by a jvp with ones (exact for elementwise diffusions)."""

    def move(t, dt, y):
        d_w = bm(t, t + dt)
        f_val = drift(t, y)
        g_val, dg = torch.func.jvp(lambda y_: diffusion(t, y_), (y,), (torch.ones_like(y),))
        corr = 0.5 * g_val * dg * (d_w * d_w - dt)
        return (f_val, g_val * d_w + corr)

    return XDETerm(move=move, fuse=_general_fuse, additive=False, kind="sde")


def make_sra1_term(drift, diffusion, bm) -> XDETerm:
    """SRA1 (Rössler 2010) for ADDITIVE noise, strong order 1.5, on the
    increment W and the time integral I10 = ∫ (W_s - W_t0) ds:

        H2 = y + 3/4 h f(t0, y) + 3/2 (I10/h) g(t0)
        y1 = y + h (f(t0,y)/3 + 2 f(t0+3/4h, H2)/3)
               + g(t1) (W - I10/h) + g(t0) (I10/h)

    (the ΔW weight on g(t1), as the Itô expansion of time-dependent g
    needs). y-dependence of g is evaluated at the step's left state and not
    corrected (the additive contract)."""

    def move(t, dt, y):
        t1 = t + dt
        w, u = bm(t, t1, return_U=True)
        i10_h = u / _safe(dt)
        k1 = drift(t, y)
        g0 = diffusion(t, y)
        h2_in = y + 0.75 * dt * k1 + 1.5 * i10_h * g0
        k2 = drift(t + 0.75 * dt, h2_in)
        g1 = diffusion(t1, y)
        noise = g1 * (w - i10_h) + g0 * i10_h
        return (k1 / 3.0 + 2.0 * k2 / 3.0, noise)

    return XDETerm(move=move, fuse=_general_fuse, additive=False, kind="sde")


def make_general_sra1_term(drift, diffusion, bm) -> XDETerm:
    """SRA1 for GENERAL (matrix) ADDITIVE noise, strong order 1.5: the
    update of :func:`make_sra1_term` with ``G(t) -> [..., D, M]`` against
    an M-dimensional bm, contracted per column."""

    def move(t, dt, y):
        t1 = t + dt
        w, u = bm(t, t1, return_U=True)  # [..., M] each
        i10_h = u / _safe(dt)
        k1 = drift(t, y)
        g0 = diffusion(t, y)  # [..., D, M]
        h2_in = y + 0.75 * dt * k1 + 1.5 * _mv(g0, i10_h)
        k2 = drift(t + 0.75 * dt, h2_in)
        g1 = diffusion(t1, y)
        noise = _mv(g1, w - i10_h) + _mv(g0, i10_h)
        return (k1 / 3.0 + 2.0 * k2 / 3.0, noise)

    return XDETerm(move=move, fuse=_general_fuse, additive=True, kind="sde")


def make_heun_stratonovich_term(drift, diffusion, bm) -> XDETerm:
    """Stratonovich Heun, trapezoidal predictor-corrector in both terms:

        y~ = y + f(t0,y) h + g(t0,y) ΔW
        y1 = y + h (f(t0,y)+f(t1,y~))/2 + ΔW (g(t0,y)+g(t1,y~))/2
    """

    def move(t, dt, y):
        t1 = t + dt
        d_w = bm(t, t1)
        f0 = drift(t, y)
        g0 = diffusion(t, y)
        y_pred = y + dt * f0 + g0 * d_w
        f1 = drift(t1, y_pred)
        g1 = diffusion(t1, y_pred)
        return (0.5 * (f0 + f1), 0.5 * (g0 + g1) * d_w)

    return XDETerm(move=move, fuse=_general_fuse, additive=False, kind="sde")


_SRIW1_BETA = (
    (-1.0, 4.0 / 3.0, 2.0 / 3.0, 0.0),
    (-1.0, 4.0 / 3.0, -1.0 / 3.0, 0.0),
    (2.0, -4.0 / 3.0, -2.0 / 3.0, 0.0),
    (-2.0, 5.0 / 3.0, -2.0 / 3.0, 1.0),
)


def make_sriw1_term(drift, diffusion, bm) -> XDETerm:
    """SRIW1 (Rössler 2010) for DIAGONAL noise, strong order 1.5, with the
    closed-form diagonal iterated integrals I1 = ΔW, I11 = (ΔW² - h)/2,
    I10 (the tree's) and I111 = (ΔW³ - 3hΔW)/6:

        H0_2 = y + 3/4 h f1 + 3/2 (I10/h) g1
        H1_2 = y + 1/4 h f1 + 1/2 √h g1
        H1_3 = y +     h f1 -     √h g1
        H1_4 = y + 1/4 h f1 + √h (-5 g1 + 3 g2 + 1/2 g3)
        y1   = y + h (f1/3 + 2 f2/3)
                 + Σ_i (β1_i I1 + β2_i I11/√h + β3_i I10/h + β4_i I111/h) g_i
    """

    def move(t, dt, y):
        t1 = t + dt
        w, u = bm(t, t1, return_U=True)
        h = _safe(dt)
        sqrt_h = torch.sqrt(h)
        i10_h = u / h
        i11_rh = (w * w - h) / (2.0 * sqrt_h)
        i111_h = (w**3 - 3.0 * h * w) / (6.0 * h)

        f1 = drift(t, y)
        g1 = diffusion(t, y)
        hf1, sg1 = h * f1, sqrt_h * g1
        # the stage sums associate as the JAX form's ``base + sum(terms)``
        h0_2 = (y + 0.75 * hf1) + 1.5 * (g1 * i10_h)
        h1_2 = y + (0.25 * hf1 + 0.5 * sg1)
        f2 = drift(t + 0.75 * dt, h0_2)
        g2 = diffusion(t + 0.25 * dt, h1_2)
        h1_3 = y + (1.0 * hf1 + -1.0 * sg1)
        g3 = diffusion(t1, h1_3)
        h1_4 = y + (0.25 * hf1 + -5.0 * sg1 + 3.0 * (sqrt_h * g2) + 0.5 * (sqrt_h * g3))
        g4 = diffusion(t + 0.25 * dt, h1_4)

        noise = torch.zeros_like(w)
        for beta, g in zip(zip(*_SRIW1_BETA), (g1, g2, g3, g4)):
            coeff = beta[0] * w + beta[1] * i11_rh + beta[2] * i10_h + beta[3] * i111_h
            noise = noise + coeff * g
        return (f1 / 3.0 + 2.0 * f2 / 3.0, noise)

    return XDETerm(move=move, fuse=_general_fuse, additive=False, kind="sde")


def _fuse_increment(dy, dt, y):
    del dt  # the increment already integrates the step
    return y + dy


def make_foster2_term(drift, diffusion, bm, substeps: int = 1) -> XDETerm:
    """Cubic polynomial-path method for ADDITIVE diagonal noise, strong
    order ~2.0: the Brownian path of each step is replaced by the cubic
    q(θ) matching the tree's (W, I10, K) triple, and

        dy/dθ = h f(t+θh, y) + g(t+θh) · q'(θ),   θ in [0, 1]

    is integrated with RK4 (``substeps`` steps). Needs a bm with
    ``levy_area_approximation='space-time-time'``."""

    def move(t, dt, y):
        t1 = t + dt
        w, u, k = bm(t, t1, return_U=True, return_K=True)
        a, b, c = _cubic_path_coeffs(w, u, k, dt)

        def F(theta, yv):
            f_val = drift(t + theta * dt, yv)
            g_val = diffusion(t + theta * dt, yv)
            return dt * f_val + g_val * (3 * a * theta**2 + 2 * b * theta + c)

        return _rk4_theta(F, y, substeps) - y

    return XDETerm(move=move, fuse=_fuse_increment, additive=False, kind="sde")


def make_foster2_general_term(drift, diffusion, bm, substeps: int = 1) -> XDETerm:
    """The cubic polynomial-path method for GENERAL (matrix) ADDITIVE noise:
    per-channel cubic paths contracted as ``G @ q'(θ)``."""

    def move(t, dt, y):
        t1 = t + dt
        w, u, k = bm(t, t1, return_U=True, return_K=True)  # [..., M] each
        a, b, c = _cubic_path_coeffs(w, u, k, dt)

        def F(theta, yv):
            f_val = drift(t + theta * dt, yv)
            g_val = diffusion(t + theta * dt, yv)
            qp = 3 * a * theta**2 + 2 * b * theta + c
            return dt * f_val + _mv(g_val, qp)

        return _rk4_theta(F, y, substeps) - y

    return XDETerm(move=move, fuse=_fuse_increment, additive=False, kind="sde")


def make_general_euler_term(drift, diffusion, bm) -> XDETerm:
    """Euler-Maruyama for GENERAL (matrix) noise: dy = f dt + G(t, y) dW with
    ``G -> [..., D, M]`` against an M-dimensional bm (size ``y.shape[:-1] +
    (M,)``). Strong order 0.5."""

    def move(t, dt, y):
        d_w = bm(t, t + dt)  # [..., M]
        return (drift(t, y), _mv(diffusion(t, y), d_w))

    return XDETerm(move=move, fuse=_general_fuse, additive=False, kind="sde")


def make_general_milstein_term(drift, diffusion, bm, *, use_area: bool = True) -> XDETerm:
    """Milstein for GENERAL (matrix) noise, strong order 1.0:

        y1 = y + f h + G ΔW + Σ_{j1,j2} (∂G_{·j2}/∂y · G_{·j1}) I(j1,j2)
        I(j1,j2) = (ΔW_{j1} ΔW_{j2} - h δ_{j1j2}) / 2 + A_{j1,j2}

    with the M directional derivatives from jvps of the diffusion (one per
    noise column) and A the tree's Lévy area; ``use_area=False`` drops A
    (exact for commutative noise)."""

    def move(t, dt, y):
        t1 = t + dt
        if use_area:
            d_w, _, a_mat = bm(t, t1, return_U=True, return_A=True)
        else:
            d_w, a_mat = bm(t, t1), None
        f_val = drift(t, y)
        g_val = diffusion(t, y)  # [..., D, M]
        m = g_val.shape[-1]
        dg_all = torch.func.vmap(
            lambda v: torch.func.jvp(lambda y_: diffusion(t, y_), (y,), (v,))[1]
        )(torch.movedim(g_val, -1, 0))  # [M(j), ..., D, M(k)]
        eye = torch.eye(m, dtype=g_val.dtype, device=g_val.device)
        i_mat = 0.5 * (d_w[..., :, None] * d_w[..., None, :] - dt * eye)
        if a_mat is not None:
            i_mat = i_mat + a_mat
        # einsum("j...dk,...jk->...d", dg_all, i_mat)
        i_j = torch.movedim(i_mat, -2, 0).unsqueeze(-2)  # [M(j), ..., 1, M(k)]
        corr = (dg_all * i_j).sum(-1).sum(0)
        return (f_val, _mv(g_val, d_w) + corr)

    return XDETerm(move=move, fuse=_general_fuse, additive=False, kind="sde")


__all__ = [
    "make_milstein_term",
    "make_sra1_term",
    "make_general_sra1_term",
    "make_heun_stratonovich_term",
    "make_sriw1_term",
    "make_foster2_term",
    "make_foster2_general_term",
    "make_general_euler_term",
    "make_general_milstein_term",
]
