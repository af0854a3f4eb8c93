"""paddlexde_tpu_torch: the PyTorch / CUDA (H100) port of paddlexde_tpu.

A package of its own beside the JAX reference: it imports ``torch`` and
numpy, never JAX or the JAX package. Entry points run on the CUDA card
unless the caller passes ``device="cpu"``; every TPU kernel on a ported path
is a hand-written CUDA kernel for Hopper (``ops/csrc``), built at first use,
with a plain PyTorch version beside it for CPU tensors.

Ported so far: D3STN serving (``models.d3stn.Predictor``) and training
(``models.d3stn.Trainer``, which also resumes from the JAX Trainer's
optimizer sidecar) and what they run: ``ddeint`` on the fixed-grid
solvers, ``history_index`` and the splines, and five kernels (spline
gather; spatial GCN and temporal attention, forward and backward); the
reference checkpoint converter (``models.d3stn.convert_reference_state_dict``),
the training CLI (``python -m paddlexde_tpu_torch.examples.train_d3stn``)
and ``utils.prefetch``; the ODE entry points ``odeint`` (fixed-grid and the
explicit adaptive solvers adaptive_heun, fehlberg2, bosh3, dopri5, dopri8,
tsit5, with autograd through the solve), ``odeint_dense`` and
``odeint_adjoint``, which run no kernel of their own; and the DDE extras
``ddeint_adjoint`` (adjoint gradients of ``ddeint``, the lag gradient
included) and ``ddeint_mos`` (true DDEs by the method of steps); the rest of
the ODE solver zoo; the CDE half (``cdeint``, the log-signatures and
``cdeint_logode``, ``NaturalCubicSpline``, ``rectilinear_interpolation``,
``fill_forward``) and the SDE core (the virtual Brownian tree on a threefry
whose bits equal JAX's, ``sdeint`` with Euler-Maruyama and the explicit
schemes, the Itô/Stratonovich conversions), which run no kernel of their
own.
"""

from . import brownian, ops  # noqa: F401
from ._device import resolve_device  # noqa: F401
from .brownian import (  # noqa: F401
    AntitheticBrownian,
    BaseBrownian,
    BrownianInterval,
    BrownianPath,
    BrownianTree,
    ReverseBrownian,
    brownian_interval_like,
)
from .functional import (  # noqa: F401
    cdeint,
    cdeint_logode,
    ddeint,
    ddeint_adjoint,
    ddeint_mos,
    format_solution,
    integrate_term,
    ito_to_stratonovich,
    logsignature_windows,
    odeint,
    odeint_adjoint,
    odeint_dense,
    odeint_event,
    odeint_event_grad,
    odeint_per_element,
    piecewise_logsignature,
    piecewise_logsignature3,
    piecewise_signature3,
    sdeint,
    stratonovich_to_ito,
)
from .interpolation import (  # noqa: F401
    BezierSpline,
    CubicHermiteSpline,
    InterpolationBase,
    LinearInterpolation,
    NaturalCubicSpline,
)
from .solver import (  # noqa: F401
    RK4,
    SDIRK2,
    SDIRK3,
    TABLEAUS,
    TRBDF2,
    AdamsBashforthMoulton,
    AdaptiveHeun,
    AdaptiveStats,
    Bosh3,
    ButcherTableau,
    DenseSolution,
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
    solve_adaptive,
    solve_adaptive_dense,
)
from .xde import (  # noqa: F401
    HistoryIndex,
    XDETerm,
    cde_term,
    dde_term,
    history_index,
    history_index_pair,
    ode_term,
    sde_term,
)

from .version import __version__  # noqa: F401
