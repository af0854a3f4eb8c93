"""Device resolution for the port's entry points.

Entry points run on the CUDA card unless the caller names another device
(the CPU tests pass ``device="cpu"``, or CPU tensors). With no card and no
explicit device they raise: the port never carries on quietly on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "input_device", "place"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda`` (raises when no CUDA device is visible); anything
    else is taken as given."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "paddlexde_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' (or CPU tensors) to run the plain "
            "PyTorch versions on the CPU"
        )
    return torch.device("cuda")


def input_device(*inputs) -> torch.device:
    """Where a function's data runs: the device of the first tensor among
    ``inputs``; with none (numpy arrays, lists, numbers) the default device
    of :func:`resolve_device` -- the card, or an error when there is none."""
    for x in inputs:
        if isinstance(x, torch.Tensor):
            return x.device
    return resolve_device()


def place(x, device: torch.device) -> torch.Tensor:
    """``x`` as a tensor: a tensor stays where it is, anything else (numpy,
    lists, numbers) goes to ``device``."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x, device=device)
