from .calculus import ito_to_stratonovich, stratonovich_to_ito  # noqa: F401
from .cdeint import cdeint  # noqa: F401
from .ddeint import ddeint  # noqa: F401
from .ddeint_adjoint import ddeint_adjoint  # noqa: F401
from .ddeint_mos import ddeint_mos  # noqa: F401
from .odeint import odeint, odeint_dense, odeint_per_element  # noqa: F401
from .odeint_adjoint import odeint_adjoint  # noqa: F401
from .odeint_event import EventResult, odeint_event, odeint_event_grad  # noqa: F401
from .solve import format_solution, integrate_term  # noqa: F401
from .logsig import (  # noqa: F401
    cdeint_logode,
    logsignature_windows,
    piecewise_logsignature,
    piecewise_logsignature3,
    piecewise_signature3,
)
from .sdeint import sdeint  # noqa: F401
