"""Symplectic integrators for separable Hamiltonian systems.

Counterpart of ``paddlexde_tpu/solver/symplectic.py``. For long-time
Hamiltonian dynamics every non-symplectic scheme drifts in energy linearly
in T, whatever its order, while a symplectic one conserves a shadow
Hamiltonian: its energy error stays bounded.

- ``leapfrog`` (velocity Verlet, kick-drift-kick): order 2.
- ``yoshida4``: Yoshida's triple-leapfrog composition with
  ``w1 = 1/(2 - 2^(1/3))``, ``w0 = 1 - 2 w1``: order 4, still symplectic.

Contract: the state is the pair ``(q, p)`` and the vector field is
separable, ``func(t, (q, p)) -> (dq, dp)`` with ``dq`` a function of ``p``
(and t) and ``dp`` of ``q`` (and t). The steps use only the term's
move/fuse hooks (fuse is affine in dy, so a half kick is
``fuse((0, dp/2), dt, y)``) and run under the fixed-grid engine.
"""

from __future__ import annotations

import torch
from torch.utils._pytree import tree_map

__all__ = ["leapfrog_step", "yoshida4_step"]

_W1 = 1.0 / (2.0 - 2.0 ** (1.0 / 3.0))
_W0 = 1.0 - 2.0 * _W1  # = -2^(1/3) w1


def _kick(term, t, dt, y, frac):
    """p += frac dt dp(t, y): fuse with the q part zeroed (an additive
    term's fuse leaves q as it is, so only p is computed)."""
    dy = term.move(t, dt, y)
    dq, dp = dy
    dp_kick = tree_map(lambda a: frac * a, dp)
    if term.additive:
        return (y[0], tree_map(lambda p, d: p + dt * d, y[1], dp_kick)), dy
    return term.fuse((tree_map(torch.zeros_like, dq), dp_kick), dt, y), dy


def _drift(term, t, dt, y, frac):
    """q += frac dt dq(t, y): fuse with the p part zeroed."""
    dq, dp = term.move(t, dt, y)
    dq_drift = tree_map(lambda a: frac * a, dq)
    if term.additive:
        return (tree_map(lambda q, d: q + dt * d, y[0], dq_drift), y[1])
    return term.fuse((dq_drift, tree_map(torch.zeros_like, dp)), dt, y)


def leapfrog_step(term, t0, t1, y0):
    """One kick-drift-kick velocity-Verlet step (order 2, symplectic)."""
    dt = t1 - t0
    y_half, k0 = _kick(term, t0, dt, y0, 0.5)
    y_drift = _drift(term, t0 + 0.5 * dt, dt, y_half, 1.0)
    y1, _ = _kick(term, t1, dt, y_drift, 0.5)
    return y1, k0


def yoshida4_step(term, t0, t1, y0):
    """Yoshida's order-4 composition leapfrog(w1 h), leapfrog(w0 h),
    leapfrog(w1 h); the negative middle sub-step buys the order."""
    dt = t1 - t0
    ta = t0 + _W1 * dt
    tb = ta + _W0 * dt
    y, k0 = leapfrog_step(term, t0, ta, y0)
    y, _ = leapfrog_step(term, ta, tb, y)
    y, _ = leapfrog_step(term, tb, t1, y)
    return y, k0
