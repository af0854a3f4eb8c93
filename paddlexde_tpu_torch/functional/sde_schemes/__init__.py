"""SDE scheme zoo: term factories and the scheme registry (see
``registry.py`` for the table every SDE surface consumes)."""

from .common import make_sde_term, noise_drift_correction  # noqa: F401
from .explicit import (  # noqa: F401
    make_foster2_general_term,
    make_foster2_term,
    make_general_euler_term,
    make_general_milstein_term,
    make_general_sra1_term,
    make_heun_stratonovich_term,
    make_milstein_term,
    make_sra1_term,
    make_sriw1_term,
)
from .registry import (  # noqa: F401
    PORTED,
    SDE_SCHEMES,
    SDESchemeSpec,
    canonical_sde_scheme_names,
    require_ported_scheme,
    resolve_sde_scheme,
)
