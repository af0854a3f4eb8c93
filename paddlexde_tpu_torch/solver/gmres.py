"""Restarted GMRES, matrix-free, with the implicit-function gradient.

Counterpart of ``jax.scipy.sparse.linalg.gmres(..., solve_method="batched")``
as JAX 0.9.0 implements it (``_gmres_batched``, ``_gmres_solve``,
``_kth_arnoldi_iteration`` in ``jax/_src/scipy/sparse/linalg.py``), which the
Newton-Krylov steps of ``solver/implicit.py`` call. PyTorch has no GMRES and
``torch.linalg`` no matrix-free solver, so it is written here in full; it
never forms the operator's matrix.

The same arithmetic as JAX's batched form:

- tolerance: ``atol = max(tol * ||b||, atol)``; the outer loop runs while
  the (left-preconditioned) residual norm ``||M(b - A x)||`` exceeds it, at
  most ``maxiter`` restarts (default ``10 * size``); ``restart`` is capped
  at the system size;
- one restart: Arnoldi on ``v -> M(A(v))`` with one classical Gram-Schmidt
  pass (JAX's "twice is enough" loop stops after its first pass, as its
  loop condition reads), a breakdown threshold of ``eps * ||M A v||``, the
  Hessenberg matrix started as ``eye(restart, restart + 1)``, and the least
  squares problem solved by its normal equations with a Cholesky factor;
- the start is ``x0 = 0``.

Where JAX's loops exit on convergence or on an Arnoldi breakdown, this one
runs the full budget (``maxiter`` restarts of ``restart`` Arnoldi steps)
and masks every step after the exit with ``torch.where``: the iterate is
JAX's, and a solve makes no device-to-host read.

Gradients follow ``lax.custom_linear_solve(A, b, solve, transpose_solve)``:
the cotangent of ``b`` is the solve of the transposed system ``A^T bbar =
xbar`` (the same GMRES, the same ``M``, and the ``atol`` fixed from the
forward's ``b``), and the tensors ``A`` depends on receive ``-(d(A x)/d
theta)^T bbar``. The Krylov loop is never differentiated.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

__all__ = ["gmres"]


def _norm(x):
    return torch.sqrt(torch.dot(x, x))


def _safe_normalize(x, thresh=None):
    """``(x / ||x||, ||x||)``, or ``(0, 0)`` when ``||x|| <= thresh``
    (default the dtype's epsilon)."""
    norm = _norm(x)
    if thresh is None:
        thresh = torch.finfo(x.dtype).eps
    use = norm > thresh
    unit = torch.where(use, x / torch.where(use, norm, torch.ones_like(norm)), torch.zeros_like(x))
    return unit, torch.where(use, norm, torch.zeros_like(norm))


def _one_restart(A, M, b, x0, unit_residual, residual_norm, restart):
    """One restart of the batched GMRES (JAX ``_gmres_batched``); the
    Arnoldi steps after a breakdown leave ``V`` and ``H`` unchanged."""
    n, dtype = b.numel(), b.dtype
    eps = torch.finfo(dtype).eps
    V = torch.zeros((restart + 1, n), dtype=dtype, device=b.device)
    V[0] = unit_residual
    H = torch.eye(restart, restart + 1, dtype=dtype, device=b.device)
    broken = torch.zeros((), dtype=torch.bool, device=b.device)
    for k in range(restart):
        v = M(A(V[k]))
        _, v_norm_0 = _safe_normalize(v)
        h = torch.mv(V, v)  # the overlaps with every column (zero columns give 0)
        q = v - torch.mv(V.T, h)
        unit_v, v_norm_1 = _safe_normalize(q, thresh=eps * v_norm_0)
        h[k + 1] = v_norm_1
        V[k + 1] = torch.where(broken, V[k + 1], unit_v)
        H[k] = torch.where(broken, H[k], h)
        broken = broken | (v_norm_1 == 0)
    beta = torch.zeros(restart + 1, dtype=dtype, device=b.device)
    beta[0] = residual_norm
    # least squares min ||H^T y - beta|| by the normal equations (JAX _lstsq)
    factor, _ = torch.linalg.cholesky_ex(H @ H.T, upper=True)
    y = torch.cholesky_solve(torch.mv(H, beta)[:, None], factor, upper=True)[:, 0]
    x = x0 + torch.mv(V[:-1].T, y)
    unit, norm = _safe_normalize(M(b - A(x)))
    return x, unit, norm


def _solve(A, M, b, atol, restart, maxiter):
    """JAX ``_gmres_solve`` from ``x0 = 0``, as a masked fixed budget."""
    x = torch.zeros_like(b)
    unit, norm = _safe_normalize(M(b - A(x)))
    for _ in range(maxiter):
        active = norm > atol
        x_new, unit_new, norm_new = _one_restart(A, M, b, x, unit, norm, restart)
        x = torch.where(active, x_new, x)
        unit = torch.where(active, unit_new, unit)
        norm = torch.where(active, norm_new, norm)
    return x


class _TransposeSolveGrad(torch.autograd.Function):
    """Value: the solution ``x``. Gradient: ``bbar = A^-T xbar`` to ``b``
    and ``-bbar`` to ``u = A(x)`` (the operator's own tensors)."""

    @staticmethod
    def forward(ctx, setup, x, b, u):
        ctx.setup = setup
        return x.clone()

    @staticmethod
    def backward(ctx, grad_x):
        A_T, M, atol, restart, maxiter = ctx.setup
        with torch.no_grad():
            bbar = _solve(A_T, M, grad_x.reshape(-1), atol, restart, maxiter)
        bbar = bbar.reshape(grad_x.shape)
        return None, None, bbar, -bbar


def _transpose_of(A, like):
    """``w -> A^T w`` of a linear ``A`` by reverse mode, one graph of ``A``."""
    with torch.enable_grad():
        v = torch.zeros_like(like).requires_grad_(True)
        Av = A(v)

    def A_T(w):
        with torch.enable_grad():
            (g,) = torch.autograd.grad(Av, v, w, retain_graph=True, allow_unused=True)
        return torch.zeros_like(w) if g is None else g

    return A_T


def gmres(
    A: Callable,
    b: torch.Tensor,
    *,
    tol: float = 1e-5,
    atol: float = 0.0,
    restart: int = 20,
    maxiter: Optional[int] = None,
    M: Optional[Callable] = None,
    A_T: Optional[Callable] = None,
):
    """Solve ``A x = b`` for a linear operator ``A`` (a callable on tensors
    of ``b``'s shape); returns ``(x, info)`` as JAX does, ``info`` a 0-dim
    tensor, -1 where ``x`` is NaN.

    ``M``: a left preconditioner approximating ``A^-1``. ``A_T``: the
    transposed operator for the gradient (default: derived from ``A`` by
    reverse mode); it is used only when a gradient flows to ``b`` or to the
    tensors ``A`` depends on."""
    shape = b.shape
    flat_b = b.reshape(-1)
    size = flat_b.numel()
    maxiter = 10 * size if maxiter is None else int(maxiter)
    restart = min(int(restart), size)
    identity = M is None

    def A_flat(v):
        return A(v.reshape(shape)).reshape(-1)

    def M_flat(v):
        return v if identity else M(v.reshape(shape)).reshape(-1)

    with torch.no_grad():
        b_d = flat_b.detach()
        atol_t = torch.clamp(tol * _norm(b_d), min=atol)
        x = _solve(A_flat, M_flat, b_d, atol_t, restart, maxiter)
    if torch.is_grad_enabled():
        u = A_flat(x)  # the operator at the solution, with its graph
        if u.requires_grad or flat_b.requires_grad:
            if A_T is None:
                A_T_flat = _transpose_of(A_flat, flat_b.detach())
            else:
                def A_T_flat(w):
                    return A_T(w.reshape(shape)).reshape(-1)
            x = _TransposeSolveGrad.apply((A_T_flat, M_flat, atol_t, restart, maxiter),
                                          x, flat_b, u)
    info = torch.where(torch.isnan(_norm(x.detach())), -1, 0)
    return x.reshape(shape), info
