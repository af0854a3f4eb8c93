from .history import HistoryIndex, history_index  # noqa: F401
from .term import XDETerm, dde_term, ode_term  # noqa: F401
