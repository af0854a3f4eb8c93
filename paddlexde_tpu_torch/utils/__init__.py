from .misc import flat_to_shape  # noqa: F401
from .norms import _linf_norm, _mixed_norm, _rms_norm, _zero_norm  # noqa: F401
from .norms import linf_norm, mixed_norm, rms_norm, zero_norm  # noqa: F401
from .ode_utils import (  # noqa: F401
    compute_error_ratio,
    interp_evaluate,
    interp_fit,
    optimal_step_size,
    select_initial_step,
    sort_tvals,
)
from .data import prefetch  # noqa: F401
from .divergence import cnf_aug_dynamics, exact_divergence, hutchinson_divergence  # noqa: F401
from .divergence import rademacher_probes  # noqa: F401
from .profiling import RunningAverageMeter, Timer, trace  # noqa: F401
