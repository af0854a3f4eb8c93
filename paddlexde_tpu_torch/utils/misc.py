"""Misc small utilities.

Counterpart of ``paddlexde_tpu/utils/misc.py``. ``flat_to_shape`` is API
parity with the reference (``paddlexde/utils/misc.py:1-13``), which
emulated tuple states over a flat trailing dimension; the port's solvers
take nested states directly, so it is here for code that used it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

__all__ = ["flat_to_shape", "host_array", "to_device"]


def host_array(x: torch.Tensor) -> np.ndarray:
    """``x``'s primal value as a numpy array (a device-to-host copy for a
    card tensor): the ``torch.func`` wrappers (jvp, vmap levels) and a
    forward-AD dual are peeled off first. The solvers read their grids and
    step decisions through it, so that ``torch.func.jvp``/``jacfwd`` run
    through a solve with its grid frozen (the JAX package's treatment of
    the grid as non-differentiable data)."""
    from torch._C import _functorch

    while _functorch.is_functorch_wrapped_tensor(x):
        x = _functorch.get_unwrapped(x)
    with torch._C._DisableFuncTorch():
        return fwAD.unpack_dual(x).primal.detach().cpu().numpy()


def to_device(array: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on ``device``: on the card through pinned
    memory and an asynchronous copy, so that no host sync is made (a copy
    from pageable memory blocks the host)."""
    host = torch.from_numpy(np.ascontiguousarray(array))
    device = torch.device(device)
    if device.type == "cpu":
        return host
    return host.pin_memory().to(device, non_blocking=True)


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
