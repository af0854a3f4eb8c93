"""paddlexde_tpu_torch: the PyTorch / CUDA (H100) port of paddlexde_tpu.

A package of its own beside the JAX reference: it imports ``torch`` and
numpy, never JAX or the JAX package. Entry points run on the CUDA card
unless the caller passes ``device="cpu"``; every TPU kernel on a ported path
is a hand-written CUDA kernel for Hopper (``ops/csrc``), built at first use,
with a plain PyTorch version beside it for CPU tensors.

Ported so far: D3STN serving (``models.d3stn.Predictor``) and training
(``models.d3stn.Trainer``) and what they run: ``ddeint`` on the fixed-grid
solvers, ``history_index`` and the splines, and five kernels (spline
gather; spatial GCN and temporal attention, forward and backward).
"""

from . import ops  # noqa: F401
from ._device import resolve_device  # noqa: F401
from .functional import ddeint, format_solution, integrate_term  # noqa: F401
from .interpolation import (  # noqa: F401
    BezierSpline,
    CubicHermiteSpline,
    InterpolationBase,
    LinearInterpolation,
)
from .solver.registry import RK4, Euler, Midpoint, SolverSpec, resolve_solver  # noqa: F401
from .xde import (  # noqa: F401
    HistoryIndex,
    XDETerm,
    dde_term,
    history_index,
    history_index_pair,
    ode_term,
)

__version__ = "0.1.0"
