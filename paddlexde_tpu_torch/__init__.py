"""paddlexde_tpu_torch: the PyTorch / CUDA (H100) port of paddlexde_tpu.

A package of its own beside the JAX reference: it imports ``torch`` and
numpy, never JAX or the JAX package. Entry points run on the CUDA card
unless the caller passes ``device="cpu"``; every TPU kernel on a ported path
is a hand-written CUDA kernel for Hopper (``ops/csrc``), built at first use,
with a plain PyTorch version beside it for CPU tensors.

Ported so far: D3STN serving (``models.d3stn.Predictor``) and what it runs:
``ddeint`` on the fixed-grid solvers, ``history_index`` and the splines, and
three kernels (spline gather, spatial GCN, temporal attention; forward).
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
from .xde import HistoryIndex, XDETerm, dde_term, history_index, ode_term  # noqa: F401

__version__ = "0.1.0"
