"""Solver registry: string names and importable solver markers.

Counterpart of ``paddlexde_tpu/solver/registry.py``. Every name of the JAX
package resolves to its :class:`SolverSpec` (a typo raises ``ValueError``),
and every one of them is ported: the explicit fixed-grid, symplectic,
Adams, implicit (dense Newton and Newton-Krylov) and explicit and implicit
(DIRK) adaptive solvers, and the host-side ``scipy_solver`` bridge.
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
    "Leapfrog",
    "Yoshida4",
    "AdamsBashforthMoulton",
    "AdaptiveHeun",
    "Fehlberg2",
    "Bosh3",
    "Dopri5",
    "Dopri8",
    "Tsit5",
    "ImplicitEuler",
    "ImplicitMidpoint",
    "ImplicitEulerKrylov",
    "SDIRK2",
    "SDIRK3",
    "Kvaerno3",
    "SDIRK4Adaptive",
    "TRBDF2",
    "ScipyWrapperODESolver",
    "SOLVERS",
    "PORTED",
]


@dataclasses.dataclass(frozen=True)
class SolverSpec:
    name: str
    kind: str  # "fixed" | "adaptive" | "adams" | "scipy"
    order: int
    implicit: bool = False

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"SolverSpec '{self.name}' is a marker passed to odeint/ddeint, not a "
            f"constructor; use odeint(func, y0, t_span, solver={self.name!r})."
        )


Euler = SolverSpec("euler", "fixed", 1)
Midpoint = SolverSpec("midpoint", "fixed", 2)
RK4 = SolverSpec("rk4", "fixed", 4)
Leapfrog = SolverSpec("leapfrog", "fixed", 2)
Yoshida4 = SolverSpec("yoshida4", "fixed", 4)
AdamsBashforthMoulton = SolverSpec("adams", "adams", 4)
AdaptiveHeun = SolverSpec("adaptive_heun", "adaptive", 2)
Fehlberg2 = SolverSpec("fehlberg2", "adaptive", 2)
Bosh3 = SolverSpec("bosh3", "adaptive", 3)
Dopri5 = SolverSpec("dopri5", "adaptive", 5)
Dopri8 = SolverSpec("dopri8", "adaptive", 8)
Tsit5 = SolverSpec("tsit5", "adaptive", 5)
ImplicitEuler = SolverSpec("implicit_euler", "fixed", 1, implicit=True)
ImplicitMidpoint = SolverSpec("implicit_midpoint", "fixed", 2, implicit=True)
ImplicitEulerKrylov = SolverSpec("implicit_euler_krylov", "fixed", 1, implicit=True)
SDIRK2 = SolverSpec("sdirk2", "fixed", 2, implicit=True)
SDIRK3 = SolverSpec("sdirk3", "fixed", 3, implicit=True)
Kvaerno3 = SolverSpec("kvaerno3", "adaptive", 3, implicit=True)
SDIRK4Adaptive = SolverSpec("sdirk4", "adaptive", 4, implicit=True)
TRBDF2 = SolverSpec("trbdf2", "adaptive", 2, implicit=True)
ScipyWrapperODESolver = SolverSpec("scipy_solver", "scipy", 0)

SOLVERS = {
    "euler": Euler,
    "midpoint": Midpoint,
    "rk4": RK4,
    "leapfrog": Leapfrog,
    "velocity_verlet": dataclasses.replace(Leapfrog, name="velocity_verlet"),
    "yoshida4": Yoshida4,
    "adams": AdamsBashforthMoulton,
    "explicit_adams": AdamsBashforthMoulton,
    "implicit_adams": dataclasses.replace(AdamsBashforthMoulton, name="implicit_adams"),
    "adams_bashforth_moulton": AdamsBashforthMoulton,
    "adaptive_heun": AdaptiveHeun,
    "fehlberg2": Fehlberg2,
    "bosh3": Bosh3,
    "dopri5": Dopri5,
    "dopri8": Dopri8,
    "tsit5": Tsit5,
    "implicit_euler": ImplicitEuler,
    "implicit_midpoint": ImplicitMidpoint,
    "gauss_legendre1": dataclasses.replace(ImplicitMidpoint, name="gauss_legendre1"),
    "backward_euler": ImplicitEuler,
    "implicit_euler_krylov": ImplicitEulerKrylov,
    "sdirk2": SDIRK2,
    "sdirk2_krylov": dataclasses.replace(SDIRK2, name="sdirk2_krylov"),
    "sdirk3": SDIRK3,
    "kvaerno3": Kvaerno3,
    "sdirk4": SDIRK4Adaptive,
    "hairer_sdirk4": SDIRK4Adaptive,
    "trbdf2": TRBDF2,
    "tr_bdf2": dataclasses.replace(TRBDF2, name="tr_bdf2"),
    "scipy_solver": ScipyWrapperODESolver,
}

PORTED = frozenset(spec.name for spec in SOLVERS.values())


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
    """Refuse a hand-made :class:`SolverSpec` whose name no engine knows."""
    if spec.name not in PORTED:
        raise ValueError(f"unknown solver {spec.name!r} ({spec.kind}); available: "
                         f"{sorted(SOLVERS)}")
