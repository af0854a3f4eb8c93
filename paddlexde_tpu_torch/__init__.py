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
included) and ``ddeint_mos`` (true DDEs by the method of steps).
"""

from . import ops  # noqa: F401
from ._device import resolve_device  # noqa: F401
from .functional import (  # noqa: F401
    ddeint,
    ddeint_adjoint,
    ddeint_mos,
    format_solution,
    integrate_term,
    odeint,
    odeint_adjoint,
    odeint_dense,
    odeint_event,
    odeint_event_grad,
    odeint_per_element,
)
from .interpolation import (  # noqa: F401
    BezierSpline,
    CubicHermiteSpline,
    InterpolationBase,
    LinearInterpolation,
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
    dde_term,
    history_index,
    history_index_pair,
    ode_term,
)

from .version import __version__  # noqa: F401
