from .adaptive import AdaptiveStats, solve_adaptive  # noqa: F401
from .adaptive_dense import DenseSolution, solve_adaptive_dense  # noqa: F401
from .fixed import make_grid, solve_fixed  # noqa: F401
from .gmres import gmres  # noqa: F401
from .registry import (  # noqa: F401
    RK4,
    SDIRK2,
    SDIRK3,
    SOLVERS,
    TRBDF2,
    AdamsBashforthMoulton,
    AdaptiveHeun,
    Bosh3,
    Dopri5,
    Dopri8,
    Euler,
    Fehlberg2,
    ImplicitEuler,
    ImplicitEulerKrylov,
    ImplicitMidpoint,
    Kvaerno3,
    Leapfrog,
    Midpoint,
    ScipyWrapperODESolver,
    SDIRK4Adaptive,
    SolverSpec,
    Tsit5,
    Yoshida4,
    resolve_solver,
)
from .tableaus import TABLEAUS, ButcherTableau  # noqa: F401
