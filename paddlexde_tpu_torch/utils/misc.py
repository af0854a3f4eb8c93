"""Misc small utilities.

Counterpart of ``paddlexde_tpu/utils/misc.py``. ``flat_to_shape`` is API
parity with the reference (``paddlexde/utils/misc.py:1-13``), which
emulated tuple states over a flat trailing dimension; the port's solvers
take nested states directly, so it is here for code that used it.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["flat_to_shape"]


def flat_to_shape(tensor, length, shapes):
    """Slice a flat trailing dimension back into a tuple of shaped tensors.

    Args:
        tensor: tensor whose last axis concatenates the flattened members.
        length: leading shape (tuple) shared by all members, prepended to each
            member shape.
        shapes: sequence of member shapes.

    Returns:
        tuple of tensors, member ``i`` reshaped to ``length + shapes[i]``.
    """
    tensor = torch.as_tensor(tensor)
    out = []
    total = 0
    for shape in shapes:
        next_total = total + (int(np.prod(shape)) if len(shape) else 1)
        out.append(tensor[..., total:next_total].reshape((*tuple(length), *tuple(shape))))
        total = next_total
    return tuple(out)
