"""Stateless virtual Brownian tree: counter-based and bit-reproducible.

Counterpart of ``paddlexde_tpu/brownian/virtual_tree.py`` on the threefry of
:mod:`.prng`, so a key gives the JAX package's path. ``W(s)`` descends a
dyadic tree over ``[t0, t1]``; the midpoint of each interval is drawn from
the exact bridge conditional with noise keyed by ``fold_in(key, node)``
(node ids are uint32 and wrap as JAX's do; :func:`tol_to_depth` caps the
depth at 28 so that they never do). The Lévy descents carry ``(w, h)`` or
``(w, u, k)`` per interval; the per-query areas (Davie, Foster, Fourier)
are keyed by the query interval's bit pattern.

How the port runs it: the path through the tree depends only on the query
times (``go_left = s < m`` in the dtype), and the times are host values, so
each query is planned on the host. The plan walks the levels with the
JAX recurrence on coefficient vectors instead of values: every output
(``W``, ``U``, ``V`` and an increment's differences of them) is a fixed
linear map of the query's standard normals (the root's and two or three per
level). The node keys are folded on the host in one vectorised call, all
the normals of the query are drawn in one batched threefry call
(:func:`~.prng.normal_rows`) and the map is one contraction on the device:
a query costs the same few hundred launches at any depth, where the level
loop would cost depth x (a hash + an ``erf_inv`` + the bridge). A fused
tree kernel is later work. The values equal the JAX recurrence's up to
rounding (the sums are associated differently; float64 parity in
tests/test_torch_brownian.py).
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.misc import host_array, to_device
from . import prng
from .prng import PRNGKey

__all__ = [
    "brownian_value_levy",
    "brownian_value_levy_k",
    "brownian_value",
    "brownian_increment",
    "brownian_triple",
    "space_time_levy_area",
    "davie_foster_area",
    "fourier_area",
    "fourier_path_coeffs",
    "fourier_triple",
    "reverse_triple",
    "h_to_u",
    "tol_to_depth",
]

_DEFAULT_DEPTH = 24
_MASK = 0xFFFFFFFF
# a pinned W(t1) (the ``W=`` argument) stands in the plan where the root
# normal would
_PINNED = None

_NP = {torch.float32: np.float32, torch.float64: np.float64}


def tol_to_depth(t0: float, t1: float, tol: Optional[float]) -> int:
    """Depth cap 28: node ids grow as ~2^(depth+2) and the Lévy descent folds
    2*node+1, which must stay below 2^31 to avoid uint32 wraparound colliding
    with other nodes' (and the root samples') fold keys."""
    if tol is None or tol <= 0:
        return _DEFAULT_DEPTH
    span = abs(float(t1) - float(t0))
    if span == 0:
        return 1
    return max(1, min(28, int(math.ceil(math.log2(span / tol)))))


def host_time(t):
    """A query time on the host in its own precision: a numpy float64 for
    Python floats (JAX's x64 reading), the tensor's dtype for a tensor (a
    device-to-host read when it lies on the card)."""
    if isinstance(t, torch.Tensor):
        return _NP.get(t.dtype, np.float32)(host_array(t.reshape(())).item())
    if isinstance(t, np.ndarray):
        return t.reshape(())[()]
    if isinstance(t, np.floating):
        return t
    return np.float64(t)


# --------------------------------------------------------------------------
# planning: the JAX recurrences on coefficient vectors
# --------------------------------------------------------------------------


class _Plan:
    """Output rows as a linear map ``coef [rows, N]`` of N noises: the
    standard normal under each fold path (``paths[j]``, the data folded
    into the tree key in order), or the pinned W(t1) where the path is
    ``_PINNED``."""

    __slots__ = ("paths", "coef")

    def __init__(self, paths, coef):
        self.paths = paths
        self.coef = coef


def _combine(terms) -> _Plan:
    """Rows ``sum_i weight_i * plan_i.coef[row_i]`` over the union of the
    plans' noises: ``terms`` is a list (one per output row) of lists of
    ``(weight, plan, row)``."""
    index, paths = {}, []
    for row_terms in terms:
        for _, plan, _ in row_terms:
            for p in plan.paths:
                if p not in index:
                    index[p] = len(paths)
                    paths.append(p)
    coef = np.zeros((len(terms), len(paths)))
    for r, row_terms in enumerate(terms):
        for weight, plan, row in row_terms:
            cols = [index[p] for p in plan.paths]
            np.add.at(coef[r], cols, weight * plan.coef[row])
    return _Plan(paths, coef)


# an increment's end is the next increment's start: the plans of recent
# query times are kept (bounded; callers only read a plan)
@functools.lru_cache(maxsize=256)
def _value_plan(mode: str, t0: float, t1: float, s: float, depth: int, dtype_name: str,
                pinned: bool) -> _Plan:
    """The plan of the absolute value(s) at ``s``: ``(W,)`` for mode
    ``"none"`` (``brownian_value``), ``(W, U)`` for ``"levy"``
    (``brownian_value_levy``), ``(W, U, V)`` for ``"levy_k"``
    (``brownian_value_levy_k``). Scalars of the time arithmetic are made in
    the dtype, as the JAX recurrence makes them."""
    f = np.dtype(dtype_name).type
    tiny = float(np.finfo(f).tiny)
    t0, t1 = f(t0), f(t1)
    s = min(max(f(s), t0), t1)
    span = t1 - t0
    roots = {"none": [(1,)], "levy": [(1,), (3,)], "levy_k": [(1,), (3,), (3, 1)]}[mode]
    per_level = {"none": 1, "levy": 2, "levy_k": 3}[mode]
    n = len(roots) + per_level * depth
    paths = [(_PINNED if pinned and p == (1,) else p) for p in roots]
    unit = np.eye(n)
    w_scale = 1.0 if pinned else float(np.sqrt(max(span, f(0.0))))
    w_tot = w_scale * unit[0]
    a, b, node = t0, t1, 2
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        if mode == "none":
            wa, wb = np.zeros(n), w_tot
            for lvl in range(depth):
                col = len(roots) + lvl
                m = f(0.5) * (a + b)
                c = float(f(0.5) * np.sqrt(max(b - a, f(0.0))))
                wm = 0.5 * (wa + wb) + c * unit[col]
                paths.append((node,))
                if s < m:
                    b, wb, node = m, wm, (2 * node) & _MASK
                else:
                    a, wa, node = m, wm, (2 * node + 1) & _MASK
            frac = f(0.0) if b == a else (s - a) / (b - a)
            return _Plan(paths, (wa + float(frac) * (wb - wa))[None])

        h_tot = float(np.sqrt(max(span / f(12.0), f(0.0)))) * unit[1]
        if mode == "levy":
            rsqrt3 = f(1.0 / np.sqrt(3.0))
            w_abs, u_abs, w, h = np.zeros(n), np.zeros(n), w_tot, h_tot
            for lvl in range(depth):
                x1, x2 = (unit[len(roots) + 2 * lvl + i] for i in (0, 1))
                m = f(0.5) * (a + b)
                delta = b - a
                half = f(0.5) * delta
                v = f(0.5) / np.sqrt(max(delta, f(tiny)))
                a_coef = v * half * half / delta
                ch = float(v * rsqrt3 * half)
                third = float(f(2.0) * (a_coef * half + a_coef * half) / delta)
                a_coef, half_c = float(a_coef), float(half)
                w_left = 0.5 * w + 1.5 * h + third * x1
                h_left = 0.25 * h - a_coef * x1 + ch * x2
                paths += [((2 * node) & _MASK,), ((2 * node + 1) & _MASK,)]
                if s < m:
                    b, w, h, node = m, w_left, h_left, (2 * node) & _MASK
                else:
                    u_left = half_c * (w_abs + 0.5 * w_left + h_left)
                    w_abs, u_abs = w_abs + w_left, u_abs + u_left
                    a, w, h = m, w - w_left, 0.25 * h - a_coef * x1 - ch * x2
                    node = (2 * node + 1) & _MASK
            frac = float(f(0.0) if b == a else (s - a) / (b - a))
            w_s = w_abs + frac * w
            u_s = u_abs + float(s - a) * (w_abs + 0.5 * frac * w)
            return _Plan(paths, np.stack([w_s, u_s]))

        # mode == "levy_k": the exact 3-dim bridge split (JAX :195-341)
        r2 = float(np.sqrt(2.0))
        cm = [[f(-1 / (2 * r2)), f(3 / r2), f(0.0)],
              [f(1 / (8 * r2)), f(-7 / (4 * r2)), f(15 / (2 * r2))],
              [f(1 / (8 * r2)), f(-5 / (4 * r2)), f(2 * r2)]]
        lm = (f(1 / (2 * r2)), f(1 / (8 * np.sqrt(6.0))), f(-r2 / 48), f(1 / np.sqrt(1440.0)))
        cm = [[float(c) for c in row] for row in cm]
        lm = [float(c) for c in lm]
        sqrt_span = f(np.sqrt(max(span, f(tiny))))
        w_hat = w_tot / float(sqrt_span)
        u_root = float(span) * (0.5 * w_tot + h_tot)
        u_hat = u_root / float(span * sqrt_span)
        k_hat = -w_hat / 12.0 + 0.5 * u_hat + float(f(1.0 / np.sqrt(720.0))) * unit[2]
        k_tot = k_hat * float(span) * float(span) * float(sqrt_span)
        w_abs, u_abs, v_abs = np.zeros(n), np.zeros(n), np.zeros(n)
        w, u, k = w_tot, u_root, k_tot
        for lvl in range(depth):
            x1, x2, x3 = (unit[len(roots) + 3 * lvl + i] for i in (0, 1, 2))
            m = f(0.5) * (a + b)
            delta = b - a
            half = f(0.5) * delta
            sqrt_delta = np.sqrt(max(delta, f(tiny)))
            sqrt_half = np.sqrt(max(half, f(tiny)))
            w_h = w / float(sqrt_delta)
            u_h = u / float(delta * sqrt_delta)
            k_h = k / float(delta * delta * sqrt_delta)
            w1 = cm[0][0] * w_h + cm[0][1] * u_h + lm[0] * x1
            u1 = cm[1][0] * w_h + cm[1][1] * u_h + cm[1][2] * k_h + lm[1] * x2
            k1 = cm[2][0] * w_h + cm[2][1] * u_h + cm[2][2] * k_h + lm[2] * x1 + lm[3] * x3
            half_c = float(half)
            w_left = w1 * float(sqrt_half)
            u_left = u1 * float(half * sqrt_half)
            k_left = k1 * float(half * half * sqrt_half)
            paths += [((2 * node) & _MASK,), ((2 * node + 1) & _MASK,), (node, 3)]
            if s < m:
                b, w, u, k, node = m, w_left, u_left, k_left, (2 * node) & _MASK
            else:
                w_r = w - w_left
                u_r = u - u_left - half_c * w_left
                k_r = k - k_left - half_c * u_left - float(f(0.5) * half * half) * w_left
                u_mid = half_c * w_abs + u_left
                v_mid = half_c * u_abs + float(f(0.5) * half * half) * w_abs + k_left
                w_abs, u_abs, v_abs = w_abs + w_left, u_abs + u_mid, v_abs + v_mid
                a, w, u, k, node = m, w_r, u_r, k_r, (2 * node + 1) & _MASK
        lam = b - a
        frac = float(f(0.0) if lam == 0 else (s - a) / lam)
        ds = s - a
        safe_lam = f(1.0) if lam == 0 else lam
        w_s = w_abs + frac * w
        u_s = u_abs + float(ds) * (w_abs + 0.5 * frac * w)
        v_s = (v_abs + float(ds) * u_abs + float(f(0.5) * ds * ds) * w_abs
               + float(ds * ds * ds / (f(6.0) * safe_lam)) * w)
        return _Plan(paths, np.stack([w_s, u_s, v_s]))


def _plan(mode, t0, t1, s, depth, dtype, pinned) -> _Plan:
    f = _NP[dtype]
    return _value_plan(mode, float(f(host_time(t0))), float(f(host_time(t1))),
                       float(f(host_time(s))), int(depth), np.dtype(f).name, bool(pinned))


# --------------------------------------------------------------------------
# execution: one batched draw and one contraction on the device
# --------------------------------------------------------------------------


def _fold_paths(key: PRNGKey, paths) -> np.ndarray:
    """The key under each fold path (one or two folds), vectorised."""
    keys = prng.fold_in_many(np.tile(key.data, (len(paths), 1)), [p[0] for p in paths])
    second = [i for i, p in enumerate(paths) if len(p) == 2]
    if second:
        keys[second] = prng.fold_in_many(keys[second], [paths[i][1] for i in second])
    return keys


# the dtype every tree draws its normals in, where not its own (None: its
# own, as JAX draws); set only within :func:`_noise_dtype`
_NOISE_DTYPE = None


@contextlib.contextmanager
def _noise_dtype(dtype):
    """Within the block every tree draws its normals in ``dtype`` and casts
    them to its own dtype. JAX draws a float32 normal from 32 random bits
    and a float64 one from 64, so a float32 and a float64 tree with one key
    are different paths; a float64 tree under ``_noise_dtype(float32)``
    follows the float32 tree's path in float64 arithmetic. It exists for a
    float64 reference of a float32 run (chip_smoke.py), not as a user
    option."""
    global _NOISE_DTYPE
    saved, _NOISE_DTYPE = _NOISE_DTYPE, dtype
    try:
        yield
    finally:
        _NOISE_DTYPE = saved


def _normal(key, shape, dtype, device):
    """``prng.normal`` as ``dtype`` (drawn as :func:`_noise_dtype` says)."""
    return prng.normal(key, shape, _NOISE_DTYPE or dtype, device).to(dtype)


def _execute(plan: _Plan, key: PRNGKey, shape, dtype, device, w_total=None):
    """The plan's rows as tensors ``[rows][*shape]`` on ``device``."""
    noise_cols = [j for j, p in enumerate(plan.paths) if p is not _PINNED]
    keys = _fold_paths(key, [plan.paths[j] for j in noise_cols])
    # the key words and the coefficients travel in one copy (uint32 words
    # are exact in float64)
    buf = to_device(np.concatenate([keys.reshape(-1).astype(np.float64),
                                      plan.coef.reshape(-1)]), device)
    n_keys = len(noise_cols)
    key_words = buf[: 2 * n_keys].to(torch.int64).reshape(n_keys, 2)
    coef = buf[2 * n_keys:].reshape(plan.coef.shape).to(dtype)
    noise = prng.normal_rows(key_words, shape, _NOISE_DTYPE or dtype, device).to(dtype)
    if len(noise_cols) < len(plan.paths):
        pinned = torch.as_tensor(w_total, dtype=dtype, device=device).expand(tuple(shape))
        j = plan.paths.index(_PINNED)
        noise = torch.cat([noise[:j], pinned[None], noise[j:]], dim=0)
    out_shape = noise.shape[1:]
    flat = coef[:, :, None] * noise.reshape(noise.shape[0], -1)[None]
    return flat.sum(dim=1).reshape((coef.shape[0],) + tuple(out_shape))


def _dtype_of(dtype):
    if dtype not in _NP:
        raise TypeError(f"the Brownian tree runs in float32 or float64, got {dtype}")
    return dtype


def brownian_value(key, t0, t1, s, shape=(), dtype=torch.float32, depth: int = _DEFAULT_DEPTH,
                   w_total=None, *, device="cpu"):
    """Absolute W(s) with W(t0) = 0 (``w_total`` pins W(t1))."""
    dtype = _dtype_of(dtype)
    plan = _plan("none", t0, t1, s, depth, dtype, w_total is not None)
    return _execute(plan, prng.as_key(key), shape, dtype, torch.device(device), w_total)[0]


def brownian_value_levy(key, t0, t1, s, shape=(), dtype=torch.float32,
                        depth: int = _DEFAULT_DEPTH, w_total=None, *, device="cpu"):
    """(W(s), U(s)) with U(s) = int_{t0}^{s} W du: the joint bridge descent."""
    dtype = _dtype_of(dtype)
    plan = _plan("levy", t0, t1, s, depth, dtype, w_total is not None)
    out = _execute(plan, prng.as_key(key), shape, dtype, torch.device(device), w_total)
    return out[0], out[1]


def brownian_value_levy_k(key, t0, t1, s, shape=(), dtype=torch.float32,
                          depth: int = _DEFAULT_DEPTH, w_total=None, *, device="cpu"):
    """(W(s), U(s), V(s)) with U = int W, V = int U: the (W, H, K) descent."""
    dtype = _dtype_of(dtype)
    plan = _plan("levy_k", t0, t1, s, depth, dtype, w_total is not None)
    out = _execute(plan, prng.as_key(key), shape, dtype, torch.device(device), w_total)
    return out[0], out[1], out[2]


def _delta(ta, tb, dtype) -> float:
    f = _NP[dtype]
    return float(f(host_time(tb)) - f(host_time(ta)))


def _interval_plan(mode, t0, t1, ta, tb, depth, dtype, pinned) -> _Plan:
    """The local rows over [ta, tb]: ``(w,)``, ``(w, u)`` or ``(w, u, k)``
    with u = int (W - W_ta) and k = int int (W - W_ta) (JAX
    ``brownian_pair`` and ``brownian_triple``)."""
    pb = _plan(mode, t0, t1, tb, depth, dtype, pinned)
    pa = _plan(mode, t0, t1, ta, depth, dtype, pinned)
    rows = [[(1.0, pb, 0), (-1.0, pa, 0)]]
    if mode != "none":
        delta = _delta(ta, tb, dtype)
        rows.append([(1.0, pb, 1), (-1.0, pa, 1), (-delta, pa, 0)])
        if mode == "levy_k":
            rows.append([(1.0, pb, 2), (-1.0, pa, 2), (-delta, pa, 1),
                         (-0.5 * delta * delta, pa, 0)])
    return _combine(rows)


def brownian_increment(key, t0, t1, ta, tb, shape=(), dtype=torch.float32,
                       depth: int = _DEFAULT_DEPTH, w_total=None, *, device="cpu"):
    """W(tb) - W(ta); consistent and additive across queries."""
    dtype = _dtype_of(dtype)
    plan = _interval_plan("none", t0, t1, ta, tb, depth, dtype, w_total is not None)
    return _execute(plan, prng.as_key(key), shape, dtype, torch.device(device), w_total)[0]


def brownian_triple(key, t0, t1, ta, tb, shape=(), dtype=torch.float32,
                    depth: int = _DEFAULT_DEPTH, w_total=None, *, device="cpu"):
    """(w, u, k) local to [ta, tb]: increment, int(W - W_ta), int int(W - W_ta)."""
    dtype = _dtype_of(dtype)
    plan = _interval_plan("levy_k", t0, t1, ta, tb, depth, dtype, w_total is not None)
    out = _execute(plan, prng.as_key(key), shape, dtype, torch.device(device), w_total)
    return out[0], out[1], out[2]


def _query_key(key: PRNGKey, ta, tb) -> PRNGKey:
    """Reproducible per-(ta, tb) key from the times' bit patterns (JAX
    :364-396): a float64 time folds in both 32-bit halves (low, then high),
    a float32 time its bits; -0.0 is folded as +0.0."""

    def fold_time(k, t):
        t = host_time(t)
        if t == 0:
            t = type(t)(0.0)
        if t.dtype == np.float64:
            bits = int(np.asarray(t).view(np.uint64))
            return prng.fold_in(prng.fold_in(k, bits & _MASK), bits >> 32)
        return prng.fold_in(k, int(np.asarray(np.float32(t)).view(np.uint32)))

    return fold_time(fold_time(key, ta), tb)


def _span(ta, tb, dtype) -> float:
    return max(_delta(ta, tb, dtype), 0.0)


def space_time_levy_area(key, ta, tb, w, shape=(), dtype=torch.float32, *, device=None):
    """H over [ta, tb] from its exact conditional H | W ~ N(0, h/12), keyed
    per query: composition-inconsistent, for single-interval statistics
    only (JAX :398-412). Drawn on ``w``'s device (or ``device``)."""
    if device is None:
        device = w.device if isinstance(w, torch.Tensor) else "cpu"
    h = _delta(ta, tb, dtype)
    x = _normal(_query_key(prng.as_key(key), ta, tb), shape, dtype, device)
    return math.sqrt(max(h / 12.0, 0.0)) * x


def h_to_u(w, h_levy, h):
    """U = h * (W/2 + H)."""
    return h * (0.5 * w + h_levy)


def davie_foster_area(key, ta, tb, w, h_levy, *, foster: bool = False):
    """Full Lévy area from (W, H): Davie's ``H_i W_j - W_i H_j`` plus a
    skew-symmetric normal of std h/sqrt(12), or Foster's variance
    ``h/10 (h/10 + H_i^2 + H_j^2)``. Scalar and 1-D states have zero area."""
    if w.dim() in (0, 1):
        return torch.zeros_like(w)
    h = _delta(ta, tb, w.dtype)
    a_mat = h_levy[..., :, None] * w[..., None, :] - w[..., :, None] * h_levy[..., None, :]
    noise = _normal(prng.fold_in(_query_key(prng.as_key(key), ta, tb), 2),
                    tuple(w.shape) + (w.shape[-1],), w.dtype, w.device)
    noise = noise - noise.transpose(-1, -2)
    if foster:
        f = _NP[w.dtype]
        tenth_h = float(f(0.1) * f(h))
        h_sq = h_levy**2
        std = torch.sqrt(tenth_h * (tenth_h + h_sq[..., :, None] + h_sq[..., None, :]))
    else:
        std = math.sqrt(h * h / 12.0)
    return a_mat + std * noise


def fourier_area(key, ta, tb, w, h_levy, *, n_terms: int = 8):
    """Full Lévy area from (W, H) by the bridge's Fourier expansion: the
    first ``n_terms`` pairs sampled (the a's conditioned on their series
    sum -H), the tail an antisymmetric normal of its exact variance (JAX
    :448-510)."""
    if w.dim() in (0, 1):
        return torch.zeros_like(w)
    dtype, dev = w.dtype, w.device
    h = _span(ta, tb, dtype)
    qkey = prng.fold_in(_query_key(prng.as_key(key), ta, tb), 3)
    k_a, k_b, k_r, k_z = prng.split(qkey, 4)
    m = w.shape[-1]
    alpha = -h_levy
    pair = torch.zeros(w.shape + (m,), dtype=dtype, device=dev)
    if n_terms > 0:
        r = torch.arange(1, n_terms + 1, dtype=dtype, device=dev)
        sig2 = h / (2.0 * math.pi**2 * r**2)
        sig = torch.sqrt(sig2)
        s_total = h / 12.0
        bshape = tuple(w.shape[:-1]) + (n_terms, m)
        a_t = _normal(k_a, bshape, dtype, dev) * sig[..., :, None]
        s_tail = torch.clamp_min(s_total - torch.sum(sig2, -1), 0.0)
        rest = _normal(k_r, tuple(w.shape), dtype, dev) * torch.sqrt(s_tail)
        tot = torch.sum(a_t, dim=-2) + rest
        safe_s = 1.0 if s_total == 0 else s_total
        a = a_t + (sig2 / safe_s)[..., :, None] * (alpha - tot)[..., None, :]
        b = _normal(k_b, bshape, dtype, dev) * sig[..., :, None]
        ra = r[..., :, None] * a
        pair = math.pi * (torch.einsum("...ri,...rj->...ij", ra, b)
                          - torch.einsum("...ri,...rj->...ij", b, ra))
        psi_n = math.pi**2 / 6.0 - float(np.sum(1.0 / np.arange(1, n_terms + 1) ** 2))
    else:
        psi_n = math.pi**2 / 6.0
    mean = w[..., :, None] * alpha[..., None, :] - alpha[..., :, None] * w[..., None, :]
    z = _normal(k_z, tuple(w.shape) + (m,), dtype, dev)
    tail = (h * math.sqrt(psi_n) / (2.0 * math.pi)) * (z - z.transpose(-1, -2))
    return mean + pair + tail


def fourier_path_coeffs(key, ta, tb, w, h_levy, *, n_terms: int = 8):
    """The truncated bridge coefficients xi = (dW, a_1..a_n, b_1..b_n) of one
    query, the a's conditioned exactly on sum a_r = -H (JAX :513-554):
    ``w.shape[:-1] + (2n+1, M)``."""
    dtype, dev = w.dtype, w.device
    h = _span(ta, tb, dtype)
    m = w.shape[-1]
    if n_terms == 0:
        return w[..., None, :]
    qkey = prng.fold_in(_query_key(prng.as_key(key), ta, tb), 4)
    k_a, k_b = prng.split(qkey)
    r = torch.arange(1, n_terms + 1, dtype=dtype, device=dev)
    sig2 = h / (2.0 * math.pi**2 * r**2)
    sig = torch.sqrt(sig2)
    bshape = tuple(w.shape[:-1]) + (n_terms, m)
    a_raw = _normal(k_a, bshape, dtype, dev) * sig[..., :, None]
    b = _normal(k_b, bshape, dtype, dev) * sig[..., :, None]
    s_n = torch.sum(sig2, -1)
    safe_s = torch.where(s_n == 0, torch.ones_like(s_n), s_n)
    a = a_raw + (sig2 / safe_s)[..., :, None] * (-h_levy - torch.sum(a_raw, dim=-2))[..., None, :]
    return torch.cat([w[..., None, :], a, b], dim=-2)


_SIG_TENSORS: dict = {}


def _signature_tensors(n, dtype, device):
    cache_key = (int(n), dtype, str(device))
    if cache_key not in _SIG_TENSORS:
        from .trig_poly import signature_tensors

        t2, t3 = signature_tensors(int(n))
        _SIG_TENSORS[cache_key] = (torch.from_numpy(t2).to(device, dtype),
                                   torch.from_numpy(t3).to(device, dtype))
    return _SIG_TENSORS[cache_key]


def _cube_and_cross(w, a_mat):
    cube = (w[..., :, None, None] * w[..., None, :, None] * w[..., None, None, :]) / 6.0
    cross = 0.5 * (w[..., :, None, None] * a_mat[..., None, :, :]
                   + a_mat[..., :, :, None] * w[..., None, None, :])
    return cube, cross


def fourier_triple(key, ta, tb, w, h_levy, *, n_terms: int = 8):
    """(A, J3): the exact level-2/3 signature of the truncated bridge path,
    rebuilt as exp(dW + A + l3) with l3 the Dynkin projection rho/3 of the
    level-3 remainder (JAX :557-615)."""
    if w.dim() in (0, 1):
        return torch.zeros_like(w), (w**3) / 6.0
    t2, t3 = _signature_tensors(n_terms, w.dtype, w.device)
    xi = fourier_path_coeffs(key, ta, tb, w, h_levy, n_terms=n_terms)
    j2 = torch.einsum("ij,...ia,...jb->...ab", t2, xi, xi)
    a_mat = 0.5 * (j2 - j2.transpose(-1, -2))
    j3_raw = torch.einsum("ijk,...ia,...jb,...kc->...abc", t3, xi, xi, xi)
    cube, cross = _cube_and_cross(w, a_mat)
    j3_exp = cube + cross
    delta = j3_raw - j3_exp
    rho = (delta - torch.einsum("...bac->...abc", delta) - torch.einsum("...bca->...abc", delta)
           + torch.einsum("...cba->...abc", delta))
    return a_mat, j3_exp + rho / 3.0


def reverse_triple(w, a_mat, j3):
    """(A~, J3~) of the time-reversed query: the group inverse of the
    forward signature (JAX :618-636)."""
    cube, cross = _cube_and_cross(w, a_mat)
    ell3 = j3 - cube - cross
    return -a_mat, -cube + cross - ell3


def brownian_pair(key, t0, t1, ta, tb, shape=(), dtype=torch.float32,
                  depth: int = _DEFAULT_DEPTH, w_total=None, levy: str = "none",
                  foster: bool = False, fourier_terms: int = 8, triple: bool = False, *,
                  device="cpu") -> Tuple:
    """(W, U, A[, J3]) over [ta, tb] (JAX :639-681): with a Lévy mode (W, U)
    come from the joint descent; ``levy`` picks the area sampler."""
    dtype = _dtype_of(dtype)
    key = prng.as_key(key)
    device = torch.device(device)
    pinned = w_total is not None
    if levy == "none":
        plan = _interval_plan("none", t0, t1, ta, tb, depth, dtype, pinned)
        return _execute(plan, key, shape, dtype, device, w_total)[0], None, None
    plan = _interval_plan("levy", t0, t1, ta, tb, depth, dtype, pinned)
    w, u = _execute(plan, key, shape, dtype, device, w_total)
    if levy == "space-time":
        return w, u, None
    delta = _delta(ta, tb, dtype)
    h_levy = torch.zeros_like(u) if delta == 0 else u / delta - 0.5 * w
    if triple:
        if levy != "fourier":
            raise ValueError(
                "the joint (W, U, A, J3) query requires levy='fourier' "
                f"(got {levy!r}): only the truncated-KL path has a "
                "consistent level-3 signature"
            )
        a, j3 = fourier_triple(key, ta, tb, w, h_levy, n_terms=fourier_terms)
        return w, u, a, j3
    if levy == "fourier":
        a = fourier_area(key, ta, tb, w, h_levy, n_terms=fourier_terms)
    else:
        a = davie_foster_area(key, ta, tb, w, h_levy, foster=(levy == "foster" or foster))
    return w, u, a
