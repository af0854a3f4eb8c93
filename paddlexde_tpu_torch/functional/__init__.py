from .ddeint import ddeint  # noqa: F401
from .solve import format_solution, integrate_term  # noqa: F401
