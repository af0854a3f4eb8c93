"""The SciPy ``solve_ivp`` bridge (host-side, eager, forward-only).

Counterpart of ``paddlexde_tpu/solver/scipy_wrapper.py``: a debug and
validation path through ``scipy.integrate.solve_ivp`` (LSODA by default).
SciPy steps on the host in float64; each right-hand-side evaluation moves
the state to the device of ``y0``, calls the field there and reads the
result back, so a solve from a card state is host-bound by design (one
host-to-device copy and one device-to-host read per evaluation). It gives
no gradients: where the JAX package raises ``TypeError`` under tracing,
this raises when an input requires grad or is a ``torch.func`` wrapper.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..xde.term import XDETerm

__all__ = ["solve_scipy"]


def _traced(x) -> bool:
    from torch._C import _functorch

    return isinstance(x, torch.Tensor) and (
        x.requires_grad or _functorch.is_functorch_wrapped_tensor(x))


def solve_scipy(term: XDETerm, y0, t_span, *, rtol=1e-7, atol=1e-9, scipy_method="LSODA"):
    """Integrate on the host with SciPy; returns a time-first ``[T, ...]``
    tree on the device of ``y0``, in its dtype."""
    from scipy.integrate import solve_ivp

    leaves, spec = tree_flatten(y0)
    leaves = [torch.as_tensor(leaf) for leaf in leaves]
    if any(_traced(leaf) for leaf in leaves) or _traced(t_span):
        raise TypeError(
            "scipy_solver is a host-side debug path and gives no gradients (an input requires "
            "grad or is a torch.func wrapper); use an adaptive native solver (e.g. 'dopri5')")
    device = leaves[0].device
    dtype = leaves[0].dtype
    for leaf in leaves[1:]:
        dtype = torch.promote_types(dtype, leaf.dtype)
    shapes = [leaf.shape for leaf in leaves]
    sizes = [leaf.numel() for leaf in leaves]
    splits = list(np.cumsum(sizes)[:-1])
    t_np = np.asarray(torch.as_tensor(t_span).detach().cpu(), np.float64)
    y0_flat = np.concatenate([leaf.detach().cpu().double().numpy().ravel() for leaf in leaves])

    def unflatten(flat):
        parts = np.split(flat, splits)
        return tree_unflatten([torch.as_tensor(p.reshape(s)).to(device=device, dtype=dtype)
                               for p, s in zip(parts, shapes)], spec)

    zero = torch.zeros((), dtype=dtype, device=device)

    def rhs(t, y_flat):
        with torch.no_grad():
            dy = term.move(torch.full((), t, dtype=dtype, device=device), zero, unflatten(y_flat))
        return np.concatenate([leaf.detach().cpu().double().numpy().ravel()
                               for leaf in tree_flatten(dy)[0]])

    sol = solve_ivp(rhs, (t_np[0], t_np[-1]), y0_flat, t_eval=t_np, method=scipy_method,
                    rtol=float(rtol), atol=float(atol))
    flat_sol = np.asarray(sol.y.T)  # [T, total]
    parts = np.split(flat_sol, splits, axis=1)
    return tree_unflatten([torch.as_tensor(p.reshape((t_np.shape[0],) + tuple(s))).to(
        device=device, dtype=dtype) for p, s in zip(parts, shapes)], spec)
