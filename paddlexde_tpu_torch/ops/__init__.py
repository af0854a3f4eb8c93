"""Hand-written Hopper kernels of the port, each beside its plain version.

Importing this package builds nothing: the CUDA sources under ``csrc/`` are
compiled at the first kernel call (``_build``).
"""

from ._build import LAUNCHES, reset_launches  # noqa: F401
from .attn import fused_temporal_attention  # noqa: F401
from .gcn import gcn_spatial_mix  # noqa: F401
from .spline import hermite_gather_eval  # noqa: F401
