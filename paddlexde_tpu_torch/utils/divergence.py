"""Divergence operators for continuous normalizing flows (FFJORD).

Counterpart of ``paddlexde_tpu/utils/divergence.py``. The instantaneous
change of variables needs ``div f = tr(df/dy)`` along the flow. Both
estimators take forward-mode products (``torch.func.jvp``, one pass per
probe, no [D, D] Jacobian), vmapped over the probes:

- :func:`exact_divergence`: D basis-vector products; exact.
- :func:`hutchinson_divergence`: k Rademacher probes, ``E[e^T J e] = tr
  J``; unbiased, O(k) cost whatever D.

Both return ``(t, y [D]) -> (f(t, y), div)`` over one event vector
(``torch.func.vmap`` for a batch, as :func:`cnf_aug_dynamics` does).
"""

from __future__ import annotations

import torch

__all__ = ["exact_divergence", "hutchinson_divergence", "cnf_aug_dynamics",
           "rademacher_probes"]


def _quadratic_forms(f, t, y, probes):
    """``(f(t, y), [e^T J e for e in probes])``."""

    def one(e):
        out, tangent = torch.func.jvp(lambda y_: f(t, y_), (y,), (e,))
        return out, tangent @ e

    outs, quad = torch.func.vmap(one)(probes)
    return outs[0], quad


def exact_divergence(f):
    """``(t, y [D]) -> (f(t, y), tr df/dy)`` by D forward-mode passes."""

    def f_and_div(t, y):
        basis = torch.eye(y.shape[-1], dtype=y.dtype, device=y.device)
        out, diag = _quadratic_forms(f, t, y, basis)
        return out, torch.sum(diag)

    return f_and_div


def rademacher_probes(shape, generator=None, dtype=torch.float32, device=None):
    """±1 probes of ``shape`` from a ``torch.Generator`` (the counterpart of
    ``jax.random.rademacher``)."""
    gen_device = generator.device if generator is not None else device
    bits = torch.randint(0, 2, tuple(shape), generator=generator, device=gen_device)
    return (2 * bits - 1).to(dtype=dtype, device=device)


def hutchinson_divergence(f, probes: int = 1):
    """``(t, y [D], eps [probes, D]) -> (f(t, y), estimate)`` with ``E[estimate]
    = tr df/dy`` over Rademacher probes ``eps`` (the JAX package draws them
    from a key; here they are passed in, e.g. from
    :func:`rademacher_probes`). The probes must stay fixed along one solve:
    resampling per step makes the integrand discontinuous in t and breaks
    adaptive solvers."""

    def f_and_div(t, y, eps):
        eps = eps.reshape(probes, y.shape[-1]).to(y.dtype)
        out, quad = _quadratic_forms(f, t, y, eps)
        return out, torch.mean(quad)

    return f_and_div


def cnf_aug_dynamics(f, divergence="exact", probes: int = 1):
    """Augmented CNF dynamics ``d(y, logp)/dt = (f, -div f)`` as a field for
    :func:`~paddlexde_tpu_torch.odeint` over the state ``(y [B, D], lp [B])``.

    ``divergence='exact'`` returns the field; ``'hutchinson'`` returns a
    factory taking per-sample probes ``[B, probes, D]`` (fixed along the
    solve) and returning the field."""
    if divergence == "exact":
        fd = exact_divergence(f)

        def field(t, state):
            y, _ = state
            out, div = torch.func.vmap(fd, in_dims=(None, 0))(t, y)
            return out, -div

        return field
    if divergence != "hutchinson":
        raise ValueError(f"divergence must be 'exact' or 'hutchinson', got {divergence!r}")
    fd = hutchinson_divergence(f, probes)

    def make_field(eps):
        def field(t, state):
            y, _ = state
            out, div = torch.func.vmap(fd, in_dims=(None, 0, 0))(t, y, eps)
            return out, -div

        return field

    return make_field
