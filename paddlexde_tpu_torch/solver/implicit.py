"""Implicit steps for stiff systems: Newton iterations on the card.

Counterpart of ``paddlexde_tpu/solver/implicit.py``. Each step solves its
stage equations ``Y = base + gamma*dt * f(t_s, Y)`` by a fixed trip of
Newton iterations (no device-to-host read), with one of two linear solvers:

- dense (``implicit_euler``, ``implicit_midpoint``, ``sdirk2``, ``sdirk3``
  and the adaptive DIRK stages): the Jacobian, then ``torch.linalg.solve``
  -- right for small and medium states (O(D^2) memory);
- matrix-free Newton-Krylov (``implicit_euler_krylov``, ``sdirk2_krylov``,
  ``make_*_step(krylov=True)``): :func:`~.gmres.gmres` on ``v -> v -
  gamma*dt * (J v)``; nothing of size D^2 is built. A non-finite Krylov
  delta leaves the iterate unchanged.

The linearization (:class:`Linearized`, the counterpart of
``jax.linearize``) is one evaluation of the field with a reverse-mode
graph per Newton iteration: the Jacobian's D rows are D backward passes
through it, and ``J v`` is one backward pass through the graph of ``J^T
u`` (built once an iteration). The JAX package takes forward mode
(``vmap(jvp)`` over the identity); reverse mode is chosen here because it
composes with the ``torch.autograd.grad`` inside ``odeint_adjoint``'s
augmented field (``torch.func`` transforms refuse it), so these steps also
integrate the adjoint system, and because forward-mode AD of a
broadcasting product takes a Python decomposition in PyTorch 2.13 (~0.3 ms
an op on a CPU). Reverse-mode autograd runs through
the steps: through the Newton iterations, and through a Krylov solve by
its transposed solve.

The Newton delta is computed at full float32 precision whatever the TF32
settings say (the JAX package solves it at "highest" precision: deltas of
TF32 or bfloat16 quality leave stage errors that large error weights, as
sdirk4's, turn into bogus error estimates).

Every step has the fixed-grid signature ``step(term, t0, t1, y0) -> (y1,
dy0)``; the ``make_*_step`` factories build custom ones (a preconditioned
Newton-Krylov step, say), which ``odeint`` takes as its ``solver``.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..xde.term import XDETerm
from .gmres import gmres

__all__ = [
    "implicit_midpoint_step",
    "make_implicit_midpoint_step",
    "implicit_euler_step",
    "make_implicit_euler_step",
    "implicit_euler_krylov_step",
    "make_implicit_euler_krylov_step",
    "sdirk2_step",
    "sdirk2_krylov_step",
    "make_sdirk2_step",
    "sdirk3_step",
    "make_sdirk3_step",
    "stage_newton_solve",
    "ravel",
    "Linearized",
]


def ravel(tree):
    """``(flat, unravel)``: every leaf raveled into one vector of the
    promoted dtype (``jax.flatten_util.ravel_pytree``)."""
    leaves, spec = tree_flatten(tree)
    shapes = [leaf.shape for leaf in leaves]
    dtypes = [leaf.dtype for leaf in leaves]
    sizes = [leaf.numel() for leaf in leaves]
    dtype = dtypes[0]
    for d in dtypes[1:]:
        dtype = torch.promote_types(dtype, d)
    flat = torch.cat([leaf.reshape(-1).to(dtype) for leaf in leaves])

    def unravel(vec):
        parts = torch.split(vec, sizes)
        return tree_unflatten([p.reshape(s).to(d) for p, s, d in zip(parts, shapes, dtypes)],
                              spec)

    return flat, unravel


@contextlib.contextmanager
def full_precision():
    """float32 matmuls and convolutions without TF32 inside the block."""
    matmul = torch.get_float32_matmul_precision()
    conv = torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(matmul)
        torch.backends.cudnn.allow_tf32 = conv


class Linearized:
    """``f`` linearized at ``y`` (the counterpart of ``jax.linearize``): one
    evaluation with a reverse-mode graph, from which ``jacobian()`` takes
    the rows (one backward pass each), ``jvp(v)`` the product ``J v`` (one
    backward pass through the graph of ``J^T u``, built once) and ``vjp(w)``
    the product ``J^T w``. With ``outer`` the graphs are kept, so that
    reverse-mode autograd runs through what is computed from them."""

    def __init__(self, f, y, outer: bool):
        self.outer = outer
        with torch.enable_grad():
            self.y_in = y if (outer and y.requires_grad) else y.detach().requires_grad_(True)
            self.f_val = f(self.y_in)
        self.linear = self.f_val.requires_grad
        self._jt = None

    @property
    def value(self):
        return self.f_val if self.outer else self.f_val.detach()

    def _grad(self, out, inp, cotangent, create_graph):
        with torch.enable_grad():
            (g,) = torch.autograd.grad(out, inp, cotangent, retain_graph=True,
                                       create_graph=create_graph, allow_unused=True)
        return torch.zeros_like(inp) if g is None else g

    def vjp(self, w):
        if not self.linear:
            return torch.zeros_like(self.y_in)
        return self._grad(self.f_val, self.y_in, w, self.outer)

    def jvp(self, v):
        if not self.linear:
            return torch.zeros_like(self.f_val)
        if self._jt is None:
            with torch.enable_grad():
                self._u = torch.zeros_like(self.f_val).requires_grad_(True)
                self._jt = self._grad(self.f_val, self.y_in, self._u, True)
        if not self._jt.requires_grad:  # f does not depend on y: J = 0
            return torch.zeros_like(self.f_val)
        return self._grad(self._jt, self._u, v, self.outer)

    def jacobian(self):
        n = self.y_in.numel()
        eye = torch.eye(n, dtype=self.f_val.dtype, device=self.f_val.device)
        if not self.linear:
            return torch.zeros((self.f_val.numel(), n), dtype=self.f_val.dtype,
                               device=self.f_val.device)
        with torch.enable_grad():
            (rows,) = torch.autograd.grad(self.f_val, self.y_in, eye, retain_graph=True,
                                          create_graph=self.outer, allow_unused=True,
                                          is_grads_batched=True)
        return torch.zeros_like(eye) if rows is None else rows


def needs_graph(f, y, *tensors) -> bool:
    """Whether reverse-mode autograd must run through a solve of ``f`` from
    ``y``: grad mode is on and ``y``, one of ``tensors`` or a tensor that
    ``f`` closes over requires grad (one evaluation of ``f`` tells)."""
    if not torch.is_grad_enabled():
        return False
    if any(isinstance(x, torch.Tensor) and x.requires_grad for x in (y,) + tensors):
        return True
    return f(y.detach()).requires_grad


def stage_newton_solve(f_at, base, gamma_dt, y_init, newton_iters, krylov_opts=None):
    """Solve ``Y = base + gamma_dt * f_at(Y)`` (flat vectors) by
    ``newton_iters`` Newton iterations from ``y_init``: the dense Jacobian
    and ``torch.linalg.solve`` when ``krylov_opts`` is None, else GMRES on
    ``v -> v - gamma_dt J v`` with those options (``tol``, ``restart``,
    ``maxiter``, ``preconditioner``)."""
    y = y_init
    outer = needs_graph(f_at, y_init, base, gamma_dt)
    eye = None if krylov_opts is not None else torch.eye(
        base.numel(), dtype=base.dtype, device=base.device)
    for _ in range(newton_iters):
        with full_precision():
            lin = Linearized(f_at, y, outer)
            residual = y - base - gamma_dt * lin.value
            if krylov_opts is None:
                # solve_ex: no check of the factor's status, so no host sync
                delta = torch.linalg.solve_ex(eye - gamma_dt * lin.jacobian(), residual)[0]
            else:
                gdt = gamma_dt.detach()

                def operator(v, lin=lin):
                    return v - gamma_dt * lin.jvp(v)

                def transposed(w, lin=lin):
                    return w - gdt * lin.vjp(w).detach()

                with torch.set_grad_enabled(outer):
                    delta, _ = gmres(
                        operator, residual, tol=krylov_opts.get("tol", 1e-8), atol=0.0,
                        restart=krylov_opts.get("restart", 20),
                        maxiter=krylov_opts.get("maxiter", 4),
                        M=krylov_opts.get("preconditioner"), A_T=transposed)
                delta = torch.where(torch.isfinite(delta), delta, torch.zeros_like(delta))
        y = y - delta
    return y if outer else y.detach()


def _flat_field(term, t_s, dt, unravel):
    def f_at(y_flat):
        return ravel(term.move(t_s, dt, unravel(y_flat)))[0]

    return f_at


def _dt_like(dt, flat):
    return dt.to(flat.dtype) if isinstance(dt, torch.Tensor) else torch.full(
        (), float(dt), dtype=flat.dtype, device=flat.device)


def make_implicit_euler_step(newton_iters: int = 6):
    """Implicit Euler with the dense Jacobian: ``y1 = y0 + dt f(t1, y1)``
    from an explicit Euler predictor (A-stable, order 1)."""

    def step(term: XDETerm, t0, t1, y0):
        dt = t1 - t0
        y0_flat, unravel = ravel(y0)
        dt_f = _dt_like(dt, y0_flat)
        dy0 = term.move(t0, dt, y0)
        y_init = y0_flat + dt_f * ravel(dy0)[0]
        y1 = stage_newton_solve(_flat_field(term, t1, dt, unravel), y0_flat, dt_f, y_init,
                                newton_iters)
        return unravel(y1), dy0

    return step


implicit_euler_step = make_implicit_euler_step()


def make_implicit_euler_krylov_step(newton_iters: int = 6, gmres_tol: float = 1e-8,
                                    gmres_restart: int = 20, gmres_maxiter: int = 4,
                                    preconditioner=None):
    """Matrix-free Newton-Krylov implicit Euler: each Newton iteration solves
    ``(I - dt J) delta = residual`` by GMRES from zero (a warm start from the
    residual makes the first GMRES residual ~ dt ||J|| ||r|| and ruins
    convergence on stiff systems). ``preconditioner``: ``v -> M^-1 v``
    approximating ``(I - dt J)^-1`` (e.g.
    :func:`~paddlexde_tpu_torch.utils.preconditioners.dirichlet_heat_preconditioner`).
    Unpreconditioned, the default 80-matvec budget resolves ``dt ||J||`` up
    to ~1e5 in float32 and ~1e6 in float64 (the JAX package's measure)."""
    opts = {"tol": gmres_tol, "restart": gmres_restart, "maxiter": gmres_maxiter,
            "preconditioner": preconditioner}

    def step(term: XDETerm, t0, t1, y0):
        dt = t1 - t0
        y0_flat, unravel = ravel(y0)
        dt_f = _dt_like(dt, y0_flat)
        dy0 = term.move(t0, dt, y0)
        y_init = y0_flat + dt_f * ravel(dy0)[0]
        y1 = stage_newton_solve(_flat_field(term, t1, dt, unravel), y0_flat, dt_f, y_init,
                                newton_iters, opts)
        return unravel(y1), dy0

    return step


implicit_euler_krylov_step = make_implicit_euler_krylov_step()


def make_implicit_midpoint_step(newton_iters: int = 8, krylov: bool = False, **krylov_opts):
    """Implicit midpoint (one-stage Gauss-Legendre): ``Y = y0 + dt f(t_mid,
    (y0 + Y)/2)``, solved as ``Z = y0 + (dt/2) f(t_mid, Z)``, ``Y = 2Z -
    y0``. Symmetric, A-stable, order 2 and symplectic for every Hamiltonian
    system, separable or not; not L-stable (R(-inf) = -1)."""

    def step(term: XDETerm, t0, t1, y0):
        dt = t1 - t0
        t_mid = t0 + 0.5 * dt
        y0_flat, unravel = ravel(y0)
        dt_f = _dt_like(dt, y0_flat)
        dy0 = term.move(t0, dt, y0)
        z_init = y0_flat + 0.5 * dt_f * ravel(dy0)[0]
        z = stage_newton_solve(_flat_field(term, t_mid, dt, unravel), y0_flat, 0.5 * dt_f,
                               z_init, newton_iters, krylov_opts if krylov else None)
        return unravel(2.0 * z - y0_flat), dy0

    return step


implicit_midpoint_step = make_implicit_midpoint_step()

# Alexander's 2-stage SDIRK, gamma = 1 - sqrt(2)/2: stiffly accurate,
# L-stable, order 2.
_SDIRK2_GAMMA = 1.0 - 0.5 * 2.0**0.5


def make_sdirk2_step(newton_iters: int = 6, krylov: bool = False, **krylov_opts):
    """L-stable order-2 SDIRK (Alexander): both stages solve ``Y = base +
    gamma dt f(t_s, Y)``; stiffly accurate (``y1 = Y2``). Dense Jacobian, or
    Newton-Krylov with ``krylov=True`` (GMRES options as keywords: ``tol``,
    ``restart``, ``maxiter``, ``preconditioner``; the stage operator is ``I -
    gamma dt J``, so a heat preconditioner takes ``dt_eff = gamma dt``)."""
    opts = (krylov_opts or {}) if krylov else None

    def step(term: XDETerm, t0, t1, y0):
        dt = t1 - t0
        y0_flat, unravel = ravel(y0)
        dt_f = _dt_like(dt, y0_flat)
        g = _SDIRK2_GAMMA  # a Python float: no host-to-device copy
        dy0 = term.move(t0, dt, y0)
        f0_flat = ravel(dy0)[0]
        t_s1 = t0 + g * dt
        f1_at = _flat_field(term, t_s1, dt, unravel)
        y1_stage = stage_newton_solve(f1_at, y0_flat, g * dt_f, y0_flat + g * dt_f * f0_flat,
                                      newton_iters, opts)
        f1_flat = f1_at(y1_stage)
        base2 = y0_flat + (1.0 - g) * dt_f * f1_flat
        y2_stage = stage_newton_solve(_flat_field(term, t1, dt, unravel), base2, g * dt_f,
                                      y1_stage + g * dt_f * f1_flat, newton_iters, opts)
        return unravel(y2_stage), dy0

    return step


sdirk2_step = make_sdirk2_step()
sdirk2_krylov_step = make_sdirk2_step(krylov=True)

# Crouzeix's 2-stage SDIRK, gamma = 1/2 + sqrt(3)/6: A-stable, order 3.
_CROUZEIX_GAMMA = 0.5 + 3.0**0.5 / 6.0


def make_sdirk3_step(newton_iters: int = 8, krylov: bool = False, **krylov_opts):
    """A-stable order-3 SDIRK (Crouzeix)::

        Y1 = y + g dt f(t + g dt, Y1)
        Y2 = y + (1 - 2g) dt f(t + g dt, Y1) + g dt f(t + (1 - g) dt, Y2)
        y1 = y + dt/2 (f(t + g dt, Y1) + f(t + (1 - g) dt, Y2))

    Neither stiffly accurate nor L-stable: on the stiff manifold ``sdirk2``
    is the more accurate of the two."""
    opts = (krylov_opts or {}) if krylov else None

    def step(term: XDETerm, t0, t1, y0):
        dt = t1 - t0
        y0_flat, unravel = ravel(y0)
        dt_f = _dt_like(dt, y0_flat)
        g = _CROUZEIX_GAMMA
        dy0 = term.move(t0, dt, y0)
        f0_flat = ravel(dy0)[0]
        t_s1 = t0 + g * dt
        f1_at = _flat_field(term, t_s1, dt, unravel)
        y1_stage = stage_newton_solve(f1_at, y0_flat, g * dt_f, y0_flat + g * dt_f * f0_flat,
                                      newton_iters, opts)
        f1_flat = f1_at(y1_stage)
        t_s2 = t0 + (1.0 - g) * dt
        f2_at = _flat_field(term, t_s2, dt, unravel)
        base2 = y0_flat + (1.0 - 2.0 * g) * dt_f * f1_flat
        y2_stage = stage_newton_solve(f2_at, base2, g * dt_f, y1_stage, newton_iters, opts)
        f2_flat = f2_at(y2_stage)
        return unravel(y0_flat + 0.5 * dt_f * (f1_flat + f2_flat)), dy0

    return step


sdirk3_step = make_sdirk3_step()
