"""Preconditioners for the matrix-free Newton-Krylov implicit solvers.

Counterpart of ``paddlexde_tpu/utils/preconditioners.py``. The Krylov steps
(``implicit_euler_krylov``, ``sdirk2_krylov``) take a ``preconditioner``
callable ``v -> M^-1 v`` approximating ``(I - c dt J)^-1``. Unpreconditioned
GMRES resolves ``dt ||J||`` only up to ~1e5 (float32) / ~1e6 (float64)
within its default budget; a good M removes that ceiling.

The heat preconditioners are the exact spectral inverses of ``I - nu dt
Laplacian`` (second-order stencil) under Dirichlet, periodic and Neumann
boundaries, applied in O(D log D) by ``torch.fft``; for a reaction-diffusion
system, preconditioning by the diffusion part alone is the classic choice.
:func:`jacobi_preconditioner` is the general diagonal fallback.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "dst1",
    "dirichlet_heat_preconditioner",
    "periodic_heat_preconditioner",
    "neumann_heat_preconditioner",
    "jacobi_preconditioner",
]


def dst1(v):
    """Un-normalized type-I discrete sine transform of the last axis via the
    FFT of the odd extension: ``2 sum_j v_j sin(pi j k / (D + 1))``.
    Self-inverse up to ``2 (D + 1)``. The transform length is ``2 (D + 1)``:
    pick ``D = 2^k - 1`` for a power-of-two FFT."""
    d = v.shape[-1]
    zeros = torch.zeros(v.shape[:-1] + (1,), dtype=v.dtype, device=v.device)
    ext = torch.cat([zeros, v, zeros, -v.flip(-1)], dim=-1)
    return (-torch.fft.fft(ext, dim=-1).imag[..., 1: d + 1]).to(v.dtype)


def dirichlet_heat_preconditioner(n, dx, dt, nu=1.0, dtype=torch.float32):
    """Exact inverse of ``I - nu dt Laplacian`` with Dirichlet boundaries:
    diagonal in sine space (eigenvalues ``-(2 - 2 cos(pi k dx)) / dx^2``),
    so transform, divide by ``1 + nu dt mu_k``, transform back. The divisor
    is rounded to ``dtype`` (float32 by default, as in the JAX package).
    Pass ``dt_eff = gamma dt`` for an SDIRK stage operator ``I - gamma dt
    J``. Pick ``n = 2^k - 1`` so the FFT length ``2 (n + 1)`` is a power
    of two."""
    k = np.arange(1, n + 1)
    mu = (2.0 - 2.0 * np.cos(np.pi * k * dx)) / dx**2
    denom = torch.as_tensor(1.0 + nu * float(dt) * mu).to(dtype)
    scale = 1.0 / (2.0 * (n + 1))
    cache = {}

    def apply(v):
        key = (v.dtype, v.device)
        if key not in cache:
            cache[key] = denom.to(device=v.device, dtype=v.dtype)
        return dst1(dst1(v) / cache[key]) * scale

    return apply


def periodic_heat_preconditioner(n, dx, dt, nu=1.0, dtype=torch.float32):
    """Exact inverse of ``I - nu dt Laplacian`` with periodic boundaries:
    one rfft/irfft pair (eigenvalues ``-(2 - 2 cos(2 pi k / n)) / dx^2``);
    ``n`` a power of two keeps the FFT fast. ``dtype`` is accepted for the
    JAX package's signature; the divisor takes the input's dtype."""
    del dtype
    k = np.arange(n // 2 + 1)
    mu = (2.0 - 2.0 * np.cos(2.0 * np.pi * k / n)) / dx**2
    denom = torch.as_tensor(1.0 + nu * float(dt) * mu)

    def apply(v):
        d = denom.to(device=v.device, dtype=v.dtype)
        return torch.fft.irfft(torch.fft.rfft(v, dim=-1) / d, n=n, dim=-1).to(v.dtype)

    return apply


def neumann_heat_preconditioner(n, dx, dt, nu=1.0, dtype=torch.float32):
    """Exact inverse of ``I - nu dt Laplacian`` with Neumann (reflecting)
    boundaries, the ghost-point stencil ``u[-1] = u[0], u[n] = u[n-1]``:
    diagonal under the type-II DCT (eigenvalues ``-(2 - 2 cos(pi k / n)) /
    dx^2``), applied by the FFT of the even extension. The JAX package
    rounds this transform through complex64 whatever the input; here it
    runs in the input's precision (complex128 for float64)."""
    del dtype
    k = np.arange(n)
    mu = (2.0 - 2.0 * np.cos(np.pi * k / n)) / dx**2
    denom = 1.0 + nu * float(dt) * mu
    phase = np.exp(-1j * np.pi * np.arange(n) / (2 * n))

    def apply(v):
        cdtype = torch.complex128 if v.dtype == torch.float64 else torch.complex64
        fwd = torch.as_tensor(phase).to(device=v.device, dtype=cdtype)
        den = torch.as_tensor(denom).to(device=v.device, dtype=v.dtype)
        ext = torch.cat([v, v.flip(-1)], dim=-1)
        coeff = (torch.fft.fft(ext, dim=-1)[..., :n] * fwd).real / 2.0
        x_half = 2.0 * (coeff / den).to(cdtype) * fwd.conj()
        x_full = torch.cat([x_half, torch.zeros(x_half.shape[:-1] + (1,), dtype=cdtype,
                                                device=v.device),
                            x_half[..., 1:].flip(-1).conj()], dim=-1)
        return torch.fft.ifft(x_full, dim=-1).real[..., :n].to(v.dtype)

    return apply


def jacobi_preconditioner(operator, y_like, *, probes=None, generator=None, floor=1e-12):
    """Diagonal (Jacobi) inverse of a linear operator ``v -> A v`` (e.g. ``A
    = I - c dt J`` of the Krylov steps), for problems with no structure to
    exploit.

    ``probes=None`` takes the exact diagonal from D basis matvecs; an int
    ``k`` estimates it by Hutchinson's ``mean_z [z * A z]`` over ``k``
    Rademacher probes drawn from ``generator`` (a ``torch.Generator``), and
    a ``[k, D]`` tensor is taken as the probes themselves (the JAX package
    draws them from a key). Entries with ``|d| < floor`` become 1."""
    y = torch.as_tensor(y_like)
    d = y.numel()

    def flat(v):
        return v.reshape(-1)

    if isinstance(probes, int) and probes < 1:
        raise ValueError(
            f"probes={probes}: need at least one Hutchinson probe (the mean over zero probes is "
            "NaN and would poison the preconditioned solve); use probes=None for the exact "
            "diagonal")
    with torch.no_grad():
        if probes is None:
            eye = torch.eye(d, dtype=y.dtype, device=y.device)
            diag = torch.stack([flat(operator(eye[i].reshape(y.shape)))[i] for i in range(d)])
        else:
            if isinstance(probes, torch.Tensor):
                z = probes.to(device=y.device, dtype=y.dtype).reshape(-1, d)
            else:
                bits = torch.randint(0, 2, (int(probes), d), generator=generator,
                                     device=generator.device if generator is not None else None)
                z = (2 * bits - 1).to(device=y.device, dtype=y.dtype)
            az = torch.stack([flat(operator(zz.reshape(y.shape))) for zz in z])
            diag = torch.mean(z * az, dim=0)
    safe = torch.where(torch.abs(diag) < floor, torch.ones_like(diag), diag)

    def apply(v):
        return (flat(v) / safe.to(v.dtype)).reshape(v.shape)

    return apply
