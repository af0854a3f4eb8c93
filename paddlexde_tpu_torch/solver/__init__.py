from .fixed import make_grid, solve_fixed  # noqa: F401
from .registry import RK4, SOLVERS, Euler, Midpoint, SolverSpec, resolve_solver  # noqa: F401
