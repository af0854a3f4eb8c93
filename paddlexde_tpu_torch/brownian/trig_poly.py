"""Closed-form resonance tensors for the truncated bridge signature.

Counterpart of ``paddlexde_tpu/brownian/trig_poly.py`` (numpy, copied): the
level-2/3 iterated Stratonovich integrals of the truncated Karhunen-Loève
bridge path

    W(x) = dW·x + sum_{r=1..n} [a_r (cos(2πrx) − 1) + b_r sin(2πrx)],  x in [0,1]

are trilinear forms in the coefficients xi = (dW, a_1..a_n, b_1..b_n)
(K = 2n+1 vector coefficients). With Φ_i the basis paths and φ_i = Φ_i'
their derivatives,

    J2[a,b]   = sum_{ij}  T2[i,j]   xi_i[a] xi_j[b]
    J3[a,b,c] = sum_{ijk} T3[i,j,k] xi_i[a] xi_j[b] xi_k[c]

where T2[i,j] = ∫₀¹ Φ_i φ_j dx and T3[i,j,k] = ∫₀¹ (∫₀ˣ Φ_i φ_j) φ_k dx are
pure numbers. They are computed exactly (closed form, not quadrature) by a
small symbolic algebra over {x^p cos(2πkx), x^p sin(2πkx)}: products by the
product-to-sum identities, antiderivatives by integration by parts, ∫₀¹ in
closed form. Tensors are cached per n.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Tuple

import numpy as np

__all__ = ["signature_tensors"]

# a function is a dict {(p, k, kind): coeff} meaning coeff · x^p · trig(2πkx)
# with kind 0 = cos, 1 = sin; k >= 0 always (normalized); (p, 0, 1) ≡ 0.
_TWO_PI = 2.0 * np.pi


def _add(f: Dict, term: Tuple[int, int, int], c: float) -> None:
    if c == 0.0:
        return
    p, k, kind = term
    if k == 0 and kind == 1:
        return  # sin(0) ≡ 0
    f[term] = f.get(term, 0.0) + c


def _mul(f: Dict, g: Dict) -> Dict:
    out: Dict = {}
    for (p1, k1, s1), c1 in f.items():
        for (p2, k2, s2), c2 in g.items():
            p = p1 + p2
            c = c1 * c2
            if s1 == 0 and s2 == 0:  # cos·cos = ½[cos(k1−k2) + cos(k1+k2)]
                _add(out, (p, abs(k1 - k2), 0), 0.5 * c)
                _add(out, (p, k1 + k2, 0), 0.5 * c)
            elif s1 == 1 and s2 == 1:  # sin·sin = ½[cos(k1−k2) − cos(k1+k2)]
                _add(out, (p, abs(k1 - k2), 0), 0.5 * c)
                _add(out, (p, k1 + k2, 0), -0.5 * c)
            elif s1 == 1 and s2 == 0:  # sin·cos = ½[sin(k1+k2) + sin(k1−k2)]
                _add(out, (p, k1 + k2, 1), 0.5 * c)
                d = k1 - k2
                _add(out, (p, abs(d), 1), 0.5 * c * (1.0 if d >= 0 else -1.0))
            else:  # cos·sin = ½[sin(k1+k2) − sin(k1−k2)]
                _add(out, (p, k1 + k2, 1), 0.5 * c)
                d = k1 - k2
                _add(out, (p, abs(d), 1), -0.5 * c * (1.0 if d >= 0 else -1.0))
    return out


def _antideriv_term(p: int, k: int, kind: int, c: float, out: Dict) -> None:
    """Accumulate ∫ c·x^p·trig(2πkx) dx (one antiderivative, constant free)."""
    if k == 0:
        _add(out, (p + 1, 0, 0), c / (p + 1))
        return
    a = _TWO_PI * k
    if kind == 0:  # ∫x^p cos = x^p sin/a − (p/a)∫x^{p−1} sin
        _add(out, (p, k, 1), c / a)
        if p > 0:
            _antideriv_term(p - 1, k, 1, -c * p / a, out)
    else:  # ∫x^p sin = −x^p cos/a + (p/a)∫x^{p−1} cos
        _add(out, (p, k, 0), -c / a)
        if p > 0:
            _antideriv_term(p - 1, k, 0, c * p / a, out)


def _integrate_from_zero(f: Dict) -> Dict:
    """F(x) = ∫₀ˣ f, i.e. the antiderivative with F(0) = 0."""
    out: Dict = {}
    for (p, k, kind), c in f.items():
        _antideriv_term(p, k, kind, c, out)
    # subtract F(0): only x^0·cos terms are nonzero at 0 (cos(0) = 1)
    f0 = sum(c for (p, k, kind), c in out.items() if p == 0 and kind == 0)
    _add(out, (0, 0, 0), -f0)
    return out


def _defint01(f: Dict) -> float:
    """∫₀¹ f = F(1) with F = ∫₀ˣ f: at x=1, x^p=1, cos(2πk)=1, sin(2πk)=0."""
    big_f = _integrate_from_zero(f)
    return float(sum(c for (p, k, kind), c in big_f.items() if kind == 0))


def _basis(n: int):
    """(Φ_i, φ_i) for i = 0..2n: i=0 the ΔW·x ramp, i=1..n the a_r modes
    (cos(2πrx) − 1), i=n+1..2n the b_r modes sin(2πrx)."""
    phis, dphis = [], []
    phis.append({(1, 0, 0): 1.0})  # x
    dphis.append({(0, 0, 0): 1.0})  # 1
    for r in range(1, n + 1):
        phis.append({(0, r, 0): 1.0, (0, 0, 0): -1.0})  # cos − 1
        dphis.append({(0, r, 1): -_TWO_PI * r})  # −2πr sin
    for r in range(1, n + 1):
        phis.append({(0, r, 1): 1.0})  # sin
        dphis.append({(0, r, 0): _TWO_PI * r})  # 2πr cos
    return phis, dphis


@lru_cache(maxsize=8)
def signature_tensors(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(T2 [K,K], T3 [K,K,K]) float64 resonance tensors for n Fourier pairs,
    K = 2n+1. T2[i,j] = ∫₀¹ Φ_i φ_j; T3[i,j,k] = ∫₀¹ (∫₀ˣ Φ_i φ_j) φ_k.
    Exact closed forms; cached per n."""
    if n < 0:
        raise ValueError(f"n_terms must be >= 0, got {n}")
    phis, dphis = _basis(n)
    k_dim = 2 * n + 1
    t2 = np.zeros((k_dim, k_dim))
    t3 = np.zeros((k_dim, k_dim, k_dim))
    for i in range(k_dim):
        for j in range(k_dim):
            prod = _mul(phis[i], dphis[j])
            t2[i, j] = _defint01(prod)
            g = _integrate_from_zero(prod)
            for k in range(k_dim):
                t3[i, j, k] = _defint01(_mul(g, dphis[k]))
    return t2, t3
