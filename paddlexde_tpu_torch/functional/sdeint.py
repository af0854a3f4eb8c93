"""sdeint: Itô (and Stratonovich) SDEs dy = f dt + g dW on a fixed grid.

Counterpart of ``paddlexde_tpu/functional/sdeint.py`` (``sdeint`` without
``adaptive``, which comes with the adaptive SDE controller, ROADMAP item 8):

- the scheme comes from the registry (``sde_schemes/registry.py``); an ODE
  solver name other than plain Euler is refused (multi-stage deterministic
  RK steppers mis-weight the Brownian increment), a scheme that is not
  ported raises ``NotImplementedError``;
- the default Brownian motion is a :class:`BrownianInterval` over the
  span's bounds with the scheme's Lévy mode and size, keyed by ``key``
  (an int, a :class:`~paddlexde_tpu_torch.brownian.PRNGKey`, or key 0), on
  the state's device: the same key gives the JAX package's path;
- ``reverse=True`` (or a decreasing span) solves in s = -t with the
  registry's reversal class (the Itô drift corrections, or none for
  Stratonovich) and a :class:`ReverseBrownian` over the same path, so a
  reverse solve retraces the forward noise.

The grid is read on the host once (none when ``t_span`` lies on the CPU);
the Brownian queries of a step plan on it and draw on the state's device
(``brownian/virtual_tree.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.utils._pytree import tree_leaves, tree_map

from .._device import input_device, place
from ..brownian.api import BrownianInterval
from ..solver.registry import resolve_solver
from ..utils.misc import host_array
from .sde_schemes.common import (
    _reversed_general_ito_fns,
    _reversed_ito_fns,
    _reversed_scalar_ito_fns,
    _reversed_stratonovich_fns,
)
from .sde_schemes.registry import (
    SDE_SCHEMES,
    canonical_sde_scheme_names,
    require_ported_scheme,
    resolve_sde_scheme,
)
from .solve import _is_decreasing, format_solution, integrate_term

__all__ = ["sdeint"]


def _host_span(t_span) -> torch.Tensor:
    """``t_span`` as a host tensor (one read when it lies on the card)."""
    if isinstance(t_span, torch.Tensor):
        if t_span.device.type == "cpu":
            return t_span
        return torch.from_numpy(host_array(t_span))
    return torch.as_tensor(np.asarray(t_span))


def _span_bounds(t_span: torch.Tensor):
    arr = host_array(t_span)
    return float(arr.min()), float(arr.max())


def _default_bm_for_scheme(solver_name, leaf, t_lo, t_hi, key, levy_area_approximation,
                           noise_dim):
    """The default BrownianInterval of a scheme (JAX ``sdeint.py:160-203``):
    the Lévy mode from the registry's ``levy`` ("space-time" schemes get
    (W, I10), "space-time-time" the (W, I10, K) triple, "area" Davie areas
    unless a full-area mode was asked), the size from its ``noise``
    (matrix noise ``y.shape[:-1] + (M,)``, scalar ``+ (1,)``, diagonal
    ``y.shape``)."""
    spec = resolve_sde_scheme(solver_name)
    levy_req = spec.levy if spec is not None else "none"
    noise = spec.noise if spec is not None else "diagonal"
    if levy_req == "space-time" and levy_area_approximation == "none":
        levy_area_approximation = "space-time"
    elif levy_req == "space-time-time":
        levy_area_approximation = "space-time-time"
    elif levy_req == "area" and levy_area_approximation in ("none", "space-time"):
        levy_area_approximation = "davie"
    if noise == "general":
        if noise_dim is None:
            raise ValueError(
                "general-noise solvers need the Brownian dimension: pass "
                "noise_dim=M (bm size becomes y.shape[:-1] + (M,)) or an "
                "explicit bm"
            )
        size = tuple(leaf.shape[:-1]) + (noise_dim,)
    elif noise == "scalar":
        size = tuple(leaf.shape[:-1]) + (1,)
    else:
        size = tuple(leaf.shape)
    return BrownianInterval(
        t_lo,
        t_hi,
        size=size,
        dtype=leaf.dtype,
        key=key,
        levy_area_approximation=levy_area_approximation,
        device=leaf.device,
    )


def sdeint(
    drift,
    diffusion,
    y0,
    t_span,
    solver="euler",
    *,
    rtol=1e-7,
    atol=1e-9,
    reverse: bool = False,
    adaptive: bool = False,
    options: Optional[dict] = None,
    bm=None,
    key=None,
    levy_area_approximation: str = "none",
    time_axis: int = -2,
    noise_dim: Optional[int] = None,
):
    """Integrate an SDE with a fixed-step scheme.

    Args:
        drift: ``f(t, y) -> dy``.
        diffusion: ``g(t, y)`` with ``y``'s shape (diagonal noise), or for
            the general-noise schemes (euler_general, milstein_general,
            milstein_commutative, sra1_general, foster2_general) a matrix
            ``G(t, y) -> [..., D, M]`` against an M-dimensional bm.
        y0: the initial state, one tensor (where it lies the solve runs;
            numpy goes to the card).
        t_span: output times, also the grid (``options`` takes
            ``step_size``/``grid``/``grid_constructor`` as for ``odeint``).
        solver: 'euler' (Euler-Maruyama), milstein (diagonal, strong 1.0),
            sra1 (additive, 1.5), sriw1 (diagonal, 1.5), heun_stratonovich
            (Stratonovich), foster2 (additive, ~2.0, on the (W, I10, K)
            triple) and the matrix-noise euler_general, milstein_general
            (Lévy areas), milstein_commutative, sra1_general,
            foster2_general; or an alias. The other names of the registry
            raise ``NotImplementedError`` (ROADMAP item 8).
        reverse: integrate from ``t_span[-1]`` backwards on the same path.
        adaptive: not ported yet (raises ``NotImplementedError``).
        bm: an explicit Brownian motion; built from ``key`` when omitted.
        key: an int, a ``PRNGKey`` or None (key 0) for the default bm.
        levy_area_approximation: the default bm's Lévy mode, where the
            scheme leaves a choice ("davie", "foster", "fourier" for the
            area schemes).
        noise_dim: M for the general-noise schemes when ``bm`` is omitted.
    """
    t_span = _host_span(t_span)
    solver_name = solver.lower() if isinstance(solver, str) else ""
    spec = resolve_sde_scheme(solver_name)
    if spec is None:
        # only plain (fixed, explicit) Euler of the deterministic registry
        # drives an SDE: a multi-stage RK stepper samples each stage's
        # increment on the stage's own sub-interval and fuses it unscaled,
        # a wrong diffusion law (JAX sdeint.py:284-309)
        ode_spec = resolve_solver(solver)
        if ode_spec.kind != "fixed" or ode_spec.implicit or ode_spec.name != "euler":
            raise ValueError(
                f"sdeint got solver={ode_spec.name!r}: multi-stage "
                "deterministic RK steppers mis-weight the Brownian increment "
                "(understated noise variance). Use 'euler' (Euler-Maruyama) "
                "or a dedicated SDE scheme: "
                + " / ".join(canonical_sde_scheme_names())
                + " (+ aliases)."
            )
        spec = SDE_SCHEMES["euler"]
    require_ported_scheme(spec)
    if adaptive:
        raise NotImplementedError(
            "sdeint(adaptive=True) is not ported to paddlexde_tpu_torch yet (ROADMAP item 8: "
            "the adaptive SDE controller comes with a later slice); use a fixed grid"
        )

    leaves = tree_leaves(y0)
    if len(leaves) != 1:
        raise ValueError(
            "sdeint's diagonal-noise contract requires a single-array state "
            f"(got a pytree with {len(leaves)} leaves); flatten the state or "
            "drive each member with its own Brownian motion"
        )
    device = input_device(*leaves)
    y0 = place(leaves[0], device)

    knob_kw = {}
    if spec.knobs:
        options = dict(options or {})
        for kname in spec.knobs:
            if kname in options:
                knob_kw[kname] = options.pop(kname)

    if bm is None:
        t_lo, t_hi = _span_bounds(t_span)
        bm = _default_bm_for_scheme(spec.name, y0, t_lo, t_hi, key, levy_area_approximation,
                                    noise_dim)
    elif (spec.levy == "space-time"
          and getattr(bm, "levy_area_approximation", "none") == "none"):
        raise ValueError(
            f"{solver} needs the space-time integral: construct the Brownian "
            "motion with levy_area_approximation='space-time'"
        )
    elif (spec.levy == "space-time-time"
          and getattr(bm, "levy_area_approximation", "none") != "space-time-time"):
        raise ValueError(
            f"{solver} needs the space-time-time integral K: construct the "
            "Brownian motion with levy_area_approximation='space-time-time'"
        )
    if spec.levy == "area":
        commutative_alt = (
            "milstein_commutative" if spec.name == "milstein_general"
            else "taylor15_commutative"
        )
        if getattr(bm, "levy_area_approximation", "none") not in ("davie", "foster", "fourier"):
            raise ValueError(
                f"{solver} needs full Lévy areas: construct the "
                "Brownian motion with levy_area_approximation='davie', "
                f"'fourier' or 'foster' (or use {commutative_alt} if the "
                "noise commutes)"
            )
        if len(getattr(bm, "shape", ())) < 2:
            raise ValueError(
                f"{solver} needs bm size [..., M] with at least a "
                "batch axis: a 1-D bm is treated as independent scalar "
                "Brownian motions whose Lévy area is zero (add a leading "
                "batch axis of 1)"
            )

    span_decreasing = _is_decreasing(t_span)
    if reverse or span_decreasing:
        span = -t_span if span_decreasing else -t_span.flip(0)
        # the registry's reversal class: Itô diagonal (+g dg/dy), scalar
        # (directional) and matrix (column trace) corrections, none for
        # Stratonovich; ReverseBrownian supplies the reversed integrals
        if spec.calculus == "stratonovich":
            rev_fns = _reversed_stratonovich_fns
        elif spec.noise == "scalar":
            rev_fns = _reversed_scalar_ito_fns
        elif spec.noise == "general":
            rev_fns = _reversed_general_ito_fns
        else:
            rev_fns = _reversed_ito_fns
        term = spec.build(*rev_fns(drift, diffusion, bm), **knob_kw)
        sol = integrate_term(term, y0, span, "euler", rtol=rtol, atol=atol, options=options,
                             time_axis=0)
        if not span_decreasing:  # reverse flag with increasing span: given order
            sol = tree_map(lambda a: a.flip(0), sol)
        return format_solution(sol, time_axis)

    term = spec.build(drift, diffusion, bm, **knob_kw)
    return integrate_term(term, y0, t_span, "euler", rtol=rtol, atol=atol, options=options,
                          time_axis=time_axis)
