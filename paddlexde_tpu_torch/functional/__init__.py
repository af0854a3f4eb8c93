from .ddeint import ddeint  # noqa: F401
from .ddeint_adjoint import ddeint_adjoint  # noqa: F401
from .ddeint_mos import ddeint_mos  # noqa: F401
from .odeint import odeint, odeint_dense, odeint_per_element  # noqa: F401
from .odeint_adjoint import odeint_adjoint  # noqa: F401
from .odeint_event import EventResult, odeint_event, odeint_event_grad  # noqa: F401
from .solve import format_solution, integrate_term  # noqa: F401
