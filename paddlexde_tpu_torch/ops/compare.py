"""How far a bfloat16 result is from another.

Two bfloat16 computations that round at the same points differ only where a
float32 sum taken in another order lands on the other side of a rounding
boundary: by one ulp of the element, on a small share of elements. The
kernels' pins and ``chip_smoke.py`` hold a bfloat16 kernel against its plain
version, and the plain versions against the TPU kernels, by this measure.
"""

from __future__ import annotations

import math

import torch

__all__ = ["bf16_errors"]


def bf16_errors(got, want):
    """``(err, ulp, share)``: max |got - want| and one bfloat16 ulp at the
    top binade of ``want`` (2^(e - 7) for 2^e <= max |want| < 2^(e + 1)),
    both divided by max |want|, and the share of elements that differ.

    The normalised ulp lies in (2^-8, 2^-7]: one flipped element of the top
    binade measures up to 7.8e-3."""
    got = torch.as_tensor(got).detach().double().cpu()
    want = torch.as_tensor(want).detach().double().cpu()
    if got.shape != want.shape:
        raise ValueError(f"shapes {tuple(got.shape)} and {tuple(want.shape)} differ")
    scale = want.abs().max().item()
    if scale == 0:
        return (got - want).abs().max().item(), 0.0, (got != want).double().mean().item()
    err = (got - want).abs().max().item() / scale
    ulp = 2.0 ** (math.floor(math.log2(scale)) - 7) / scale
    return err, ulp, (got != want).double().mean().item()
