from .adaptive import AdaptiveStats, solve_adaptive  # noqa: F401
from .adaptive_dense import DenseSolution, solve_adaptive_dense  # noqa: F401
from .fixed import make_grid, solve_fixed  # noqa: F401
from .registry import (  # noqa: F401
    RK4,
    SOLVERS,
    AdaptiveHeun,
    Bosh3,
    Dopri5,
    Dopri8,
    Euler,
    Fehlberg2,
    Midpoint,
    SolverSpec,
    Tsit5,
    resolve_solver,
)
from .tableaus import TABLEAUS, ButcherTableau  # noqa: F401
