"""Error norms over tensor states (tensors or nested containers of tensors).

Counterpart of ``paddlexde_tpu/utils/norms.py``: every norm takes a whole
state tree, so the solvers never special-case tuple states. The results are
0-dim tensors on the leaves' device (no host read).
"""

from __future__ import annotations

import torch
from torch.utils._pytree import tree_leaves

__all__ = ["linf_norm", "rms_norm", "zero_norm", "mixed_norm"]


def _leaves(tree):
    return [torch.as_tensor(leaf) for leaf in tree_leaves(tree)]


def linf_norm(tree) -> torch.Tensor:
    """max |x| over every element of every leaf."""
    leaves = _leaves(tree)
    if not leaves:
        return torch.zeros(())
    return torch.stack([torch.max(torch.abs(leaf)) for leaf in leaves]).max()


def rms_norm(tree) -> torch.Tensor:
    """Global root-mean-square over all elements of all leaves (size-weighted)."""
    leaves = _leaves(tree)
    if not leaves:
        return torch.zeros(())
    sq_sums = [torch.sum(torch.square(torch.abs(leaf))) for leaf in leaves]
    n = sum(leaf.numel() for leaf in leaves)
    return torch.sqrt(sum(sq_sums) / n)


def zero_norm(tree) -> torch.Tensor:
    """Always zero: every step is accepted."""
    leaves = _leaves(tree)
    device = leaves[0].device if leaves else None
    return torch.zeros((), device=device)


def mixed_norm(tree) -> torch.Tensor:
    """max over leaves of the per-leaf RMS norm: for states whose members
    live on very different scales (the adjoint's augmented state), where a
    size-weighted global RMS would drown the small members."""
    leaves = _leaves(tree)
    if not leaves:
        return torch.zeros(())
    return torch.stack([rms_norm(leaf) for leaf in leaves]).max()


# the reference's underscore names (``options={"norm": _rms_norm}``)
_linf_norm = linf_norm
_rms_norm = rms_norm
_zero_norm = zero_norm
_mixed_norm = mixed_norm
