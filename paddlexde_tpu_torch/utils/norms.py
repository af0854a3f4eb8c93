"""Error norms over tensor states (tensors or nested containers of tensors).

Counterpart of ``paddlexde_tpu/utils/norms.py``. Only ``rms_norm``, the
default ``norm`` option of the solvers, is ported so far.
"""

from __future__ import annotations

import torch
from torch.utils._pytree import tree_leaves

__all__ = ["rms_norm"]


def rms_norm(tree) -> torch.Tensor:
    """Global root-mean-square over all elements of all leaves (size-weighted)."""
    leaves = [torch.as_tensor(leaf) for leaf in tree_leaves(tree)]
    if not leaves:
        return torch.zeros(())
    sq_sums = [torch.sum(torch.square(torch.abs(leaf))) for leaf in leaves]
    n = sum(leaf.numel() for leaf in leaves)
    return torch.sqrt(sum(sq_sums) / n)
