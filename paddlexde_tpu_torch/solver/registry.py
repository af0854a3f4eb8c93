"""Solver registry: string names and importable solver markers.

Counterpart of ``paddlexde_tpu/solver/registry.py``. Every name of the JAX
package resolves to its :class:`SolverSpec`, so a typo still raises
``ValueError``. Ported: the explicit fixed-grid solvers euler, midpoint and
rk4 and the explicit adaptive ones adaptive_heun, fehlberg2, bosh3, dopri5,
dopri8 and tsit5; :func:`require_ported` raises ``NotImplementedError`` for
the rest (ROADMAP.md lists them).
"""

from __future__ import annotations

import dataclasses

__all__ = [
    "SolverSpec",
    "resolve_solver",
    "require_ported",
    "Euler",
    "Midpoint",
    "RK4",
    "AdaptiveHeun",
    "Fehlberg2",
    "Bosh3",
    "Dopri5",
    "Dopri8",
    "Tsit5",
    "SOLVERS",
    "PORTED",
]


@dataclasses.dataclass(frozen=True)
class SolverSpec:
    name: str
    kind: str  # "fixed" | "adaptive" | "adams" | "scipy"
    order: int
    implicit: bool = False


Euler = SolverSpec("euler", "fixed", 1)
Midpoint = SolverSpec("midpoint", "fixed", 2)
RK4 = SolverSpec("rk4", "fixed", 4)
AdaptiveHeun = SolverSpec("adaptive_heun", "adaptive", 2)
Fehlberg2 = SolverSpec("fehlberg2", "adaptive", 2)
Bosh3 = SolverSpec("bosh3", "adaptive", 3)
Dopri5 = SolverSpec("dopri5", "adaptive", 5)
Dopri8 = SolverSpec("dopri8", "adaptive", 8)
Tsit5 = SolverSpec("tsit5", "adaptive", 5)

_Leapfrog = SolverSpec("leapfrog", "fixed", 2)
_Adams = SolverSpec("adams", "adams", 4)
_ImplicitEuler = SolverSpec("implicit_euler", "fixed", 1, implicit=True)
_ImplicitMidpoint = SolverSpec("implicit_midpoint", "fixed", 2, implicit=True)
_SDIRK2 = SolverSpec("sdirk2", "fixed", 2, implicit=True)
_SDIRK4 = SolverSpec("sdirk4", "adaptive", 4, implicit=True)
_TRBDF2 = SolverSpec("trbdf2", "adaptive", 2, implicit=True)

SOLVERS = {
    "euler": Euler,
    "midpoint": Midpoint,
    "rk4": RK4,
    "leapfrog": _Leapfrog,
    "velocity_verlet": dataclasses.replace(_Leapfrog, name="velocity_verlet"),
    "yoshida4": SolverSpec("yoshida4", "fixed", 4),
    "adams": _Adams,
    "explicit_adams": _Adams,
    "implicit_adams": dataclasses.replace(_Adams, name="implicit_adams"),
    "adams_bashforth_moulton": _Adams,
    "adaptive_heun": AdaptiveHeun,
    "fehlberg2": Fehlberg2,
    "bosh3": Bosh3,
    "dopri5": Dopri5,
    "dopri8": Dopri8,
    "tsit5": Tsit5,
    "implicit_euler": _ImplicitEuler,
    "implicit_midpoint": _ImplicitMidpoint,
    "gauss_legendre1": dataclasses.replace(_ImplicitMidpoint, name="gauss_legendre1"),
    "backward_euler": _ImplicitEuler,
    "implicit_euler_krylov": SolverSpec("implicit_euler_krylov", "fixed", 1, implicit=True),
    "sdirk2": _SDIRK2,
    "sdirk2_krylov": dataclasses.replace(_SDIRK2, name="sdirk2_krylov"),
    "sdirk3": SolverSpec("sdirk3", "fixed", 3, implicit=True),
    "kvaerno3": SolverSpec("kvaerno3", "adaptive", 3, implicit=True),
    "sdirk4": _SDIRK4,
    "hairer_sdirk4": _SDIRK4,
    "trbdf2": _TRBDF2,
    "tr_bdf2": dataclasses.replace(_TRBDF2, name="tr_bdf2"),
    "scipy_solver": SolverSpec("scipy_solver", "scipy", 0),
}

PORTED = frozenset({"euler", "midpoint", "rk4", "adaptive_heun", "fehlberg2", "bosh3",
                    "dopri5", "dopri8", "tsit5"})


def resolve_solver(solver) -> SolverSpec:
    if isinstance(solver, SolverSpec):
        return solver
    if isinstance(solver, str):
        key = solver.lower()
        if key in SOLVERS:
            return SOLVERS[key]
        raise ValueError(f"unknown solver {solver!r}; available: {sorted(SOLVERS)}")
    raise TypeError(
        f"solver must be a SolverSpec or string, got {type(solver).__name__}"
    )


def require_ported(spec: SolverSpec) -> None:
    if spec.name not in PORTED:
        raise NotImplementedError(
            f"solver {spec.name!r} ({spec.kind}) is not ported to PyTorch yet; "
            f"ported: {sorted(PORTED)}. ROADMAP.md lists the order of the rest."
        )
