"""The arithmetic of the GCN backward kernel K3 on the tensor cores, emulated on the CPU.

K3 (``paddlexde_tpu_torch/ops/csrc/gcn_bwd.cu``) runs its N^2 D products as
TF32 tensor-core products in 3xTF32: each float32 operand splits into
big = tf32(v) and small = v - big (exact in float32; the tensor cores read
its top 19 bits, which truncates it to TF32), and a b is taken as
small_a big_b + big_a small_b + big_a big_b. The tensor cores sum a chain of
8 k-steps (a score's 64 features, a mix's 64 nodes) and the kernel adds each
chain's sum to a float32 total on the CUDA cores. Between the products it
works in float32: the row pass takes the softmax online over node tiles of
64 (running max, sum and r, the mixes rescaled by alpha), the column pass
takes p0, a and ds from the row statistics.

This file emulates one (batch, step) slice at PEMS08's N = 170 and
D = 128 that way with numpy: TF32 rounding of big (to nearest, ties away
from zero), truncation of small, each chain's products summed in float64
and rounded to float32 once, the chains and the rest in float32. It holds
dx and the slice's dgate partial against ``gcn_spatial_mix_bwd_plain`` in
float64 (pinned to the JAX TPU kernel in interpret mode by
``tests/test_torch_gcn.py``) at a normalised max-abs error of 1e-5, the
limit K3 is held to on the card. One TF32 product (big_a big_b alone) misses
that limit, which is why the kernel pays for three.
"""

import math

import numpy as np
import pytest
import torch

from paddlexde_tpu_torch.ops import gcn

N, D = 170, 128
NT = 64       # nodes per tile
CHAIN_K = 64  # the contraction length of one tensor-core chain (8 k-steps)
TOL = 1e-5


def tf32(x):
    """Round float32 to TF32 (10 mantissa bits), nearest, ties away from zero."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def truncate(x):
    """What the tensor cores read of a float32 operand: its top 19 bits."""
    return (np.asarray(x, np.float32).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    big = tf32(x)
    return big, truncate(np.asarray(x, np.float32) - big)


def chain(a, b, terms):
    """a [M, K] @ b [K, N] over one chain (K <= 64) in float64, rounded once
    to float32; ``terms`` 3 (3xTF32, the kernel's order) or 1 (plain TF32)."""
    (ab, as_), (bb, bs) = split(a), split(b)
    pairs = ((as_, bb), (ab, bs), (ab, bb)) if terms == 3 else ((ab, bb),)
    return np.float32(sum(p.astype(np.float64) @ q.astype(np.float64) for p, q in pairs))


def product(a, b, terms):
    """a @ b over K in chains of CHAIN_K, the chains added in float32."""
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], CHAIN_K):
        acc = np.float32(acc + chain(a[:, k0 : k0 + CHAIN_K], b[k0 : k0 + CHAIN_K], terms))
    return acc


def k3_slice(x, g, gate, scale2, terms=3):
    """(dx, dgate partial) of one slice x, g [N, D] as K3 computes them."""
    n, d = x.shape
    f32 = np.float32
    scale1 = f32(1.0 / math.sqrt(d))
    s = product(x, x.T, terms)   # s[n, m] = x_n . x_m, both passes
    da = product(g, x.T, terms)  # da[n, m] = g_n . x_m

    # row pass: online softmax over node tiles, U = sum (e gate da) x_m,
    # V = sum e x_m, both rescaled by alpha at each tile's chain
    run_max = np.full((n, 1), -np.inf, f32)
    run_sum = np.zeros((n, 1), f32)
    run_r = np.zeros((n, 1), f32)
    u = np.zeros((n, d), f32)
    v = np.zeros((n, d), f32)
    for m0 in range(0, n, NT):
        st = f32(s[:, m0 : m0 + NT] * scale1)
        new_max = np.maximum(run_max, st.max(axis=1, keepdims=True))
        alpha = np.exp(run_max - new_max).astype(f32)
        e = np.exp(st - new_max).astype(f32)
        w = f32(e * f32(gate[:, m0 : m0 + NT] * da[:, m0 : m0 + NT]))
        run_sum = f32(run_sum * alpha + e.sum(axis=1, keepdims=True, dtype=f32))
        run_r = f32(run_r * alpha + w.sum(axis=1, keepdims=True, dtype=f32))
        run_max = new_max
        xm = x[m0 : m0 + NT]
        u = f32(u * alpha + chain(w, xm, terms))
        v = f32(v * alpha + chain(e, xm, terms))
    inv = f32(1.0) / run_sum
    r = f32(f32(scale2) * run_r * inv)
    dx = f32(scale1 * f32(f32(scale2) * u * inv - r * f32(v * inv)))

    # column pass: p0, a and scale1 ds from the row statistics; dx[m] +=
    # sum_n a[n, m] g_n + scale1 ds[n, m] x_n over row tiles
    p0 = f32(np.exp(f32(s * scale1) - run_max).astype(f32) * inv)
    a = f32(f32(p0 * f32(scale2)) * gate)
    ds = f32(scale1 * f32(p0 * f32(f32(f32(scale2) * gate) * da - r)))
    dgate = f32(f32(p0 * f32(scale2)) * da)
    col = np.zeros((n, d), f32)
    for n0 in range(0, n, NT):
        col = f32(col + chain(a[n0 : n0 + NT].T, g[n0 : n0 + NT], terms))
        col = f32(col + chain(ds[n0 : n0 + NT].T, x[n0 : n0 + NT], terms))
    return f32(dx + col), dgate


def _slice(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D)).astype(np.float32)
    g = rng.standard_normal((N, D)).astype(np.float32)
    gate = (0.5 * rng.random((N, N))).astype(np.float32)
    return x, g, gate


def _err(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max()


def _want(x, g, gate, scale2):
    dx, dgate = gcn.gcn_spatial_mix_bwd_plain(torch.tensor(x).double()[None, :, None],
                                              torch.tensor(gate).double(),
                                              torch.tensor(g).double()[None, :, None], scale2)
    return dx[0, :, 0].numpy(), dgate.numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_3xtf32_gcn_backward_matches_float64(seed):
    x, g, gate = _slice(seed)
    scale2 = 1.0 / math.sqrt(D)
    dx, dgate = k3_slice(x, g, gate, scale2)
    want_dx, want_dgate = _want(x, g, gate, scale2)
    assert dx.shape == want_dx.shape and dgate.shape == want_dgate.shape
    assert _err(dx, want_dx) <= TOL
    assert _err(dgate, want_dgate) <= TOL


def test_one_tf32_product_misses_the_tolerance():
    x, g, gate = _slice(2)
    scale2 = 1.0 / math.sqrt(D)
    want_dx, want_dgate = _want(x, g, gate, scale2)
    dx, dgate = k3_slice(x, g, gate, scale2, terms=1)
    assert max(_err(dx, want_dx), _err(dgate, want_dgate)) > 10 * TOL


def test_split_is_exact():
    x = np.random.default_rng(3).standard_normal(1000).astype(np.float32)
    big, small = split(x)
    assert np.array_equal(tf32(big), big) and np.array_equal(truncate(small), small)
    # big + small is x to within the truncation of small: 2^-21 of |x|
    assert np.all(np.abs((big.astype(np.float64) + small) - x) <= 2.0 ** -21 * np.abs(x))
