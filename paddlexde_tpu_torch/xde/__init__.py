from .history import HistoryIndex, history_index, history_index_pair  # noqa: F401
from .term import XDETerm, dde_term, ode_term  # noqa: F401
