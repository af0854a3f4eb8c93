"""The arithmetic of the attention kernels' tensor-core convs, emulated on the CPU.

K4 and K5 (``paddlexde_tpu_torch/ops/csrc/tc_conv.cuh``, ``attn_bwd.cu``) run
their temporal convs and weight-gradient reductions as TF32 tensor-core
products in 3xTF32: each float32 x splits into big = tf32(x) and
small = x - big (exact in float32; the tensor cores read its top 19 bits,
which truncates it to TF32), and x w is taken as small_x big_w +
big_x small_w + big_x big_w, in that order. The tensor cores sum a short chain of products
(one weight chunk of a conv, four k-steps of eight (row, t) pairs of a
weight gradient) and the kernel adds each chain's sum to a float32 total.

This file emulates that with numpy: TF32 rounding of big (the float32
mantissa rounded to 10 bits, to nearest, ties away from zero, as
``cvt.rna.tf32.f32``) and truncation of small,
each chain's products summed in float64 and rounded to float32 once, the
chains added in float32. It holds the emulation at D3STN's widths (T = 12,
D = 128, K = 3) against the port's plain versions in float64, for the three
left paddings the kernels use (2: causal, 1: same, 0: the input gradient of
a causal conv) and for a weight gradient over 4128 (row, t) pairs. The
plain versions are pinned to JAX's oracles of ``attn_pallas.py``:
``_tconv_ref`` in float64 (to 1e-12), ``_tconv_bwd_input`` and
``_conv_weight_grads`` to 1e-6 (they return float32 sums,
``preferred_element_type=float32``, whatever the input type).

Tolerance: normalised max-abs error 1e-5 against float64, the limit K5 is
held to on the card. 3xTF32 keeps each product to about 2^-21 (~1e-6 of the
result); one TF32 product (big_x big_w alone) keeps 2^-11 and misses the
limit by more than 10x, which is why the kernels pay for three.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlexde_tpu.ops import attn_pallas
from paddlexde_tpu_torch.ops import attn

T, D, K = 12, 128, 3
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _x64_and_one_thread():
    """The float64 oracles need JAX's x64 (another test may have turned it
    off); one torch thread, as the suite's other port tests."""
    before_x64, before_threads = jax.config.jax_enable_x64, torch.get_num_threads()
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(1)
    yield
    jax.config.update("jax_enable_x64", before_x64)
    torch.set_num_threads(before_threads)


def tf32(x):
    """Round float32 to TF32 (10 mantissa bits), nearest, ties away from zero."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def truncate(x):
    """What the tensor cores read of a float32 operand: its top 19 bits."""
    return (np.asarray(x, np.float32).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    big = tf32(x)
    return big, truncate(np.float32(x) - big)


def _products(a, b, terms):
    """sum_k a[..., k] b[k, ...] over the chain in float64, rounded once to
    float32; ``terms`` 3 (3xTF32, the kernels' order) or 1 (plain TF32)."""
    (ab, as_), (bb, bs) = split(a), split(b)
    pairs = ((as_, bb), (ab, bs), (ab, bb)) if terms == 3 else ((ab, bb),)
    return np.float32(sum(x.astype(np.float64) @ y.astype(np.float64) for x, y in pairs))


def conv_tc(x, w, b, padl, terms=3, kc=8):
    """out[r, t] = b + sum_j x[r, t + j - padl] w[j] as the kernel runs it:
    per chunk of ``kc`` input channels the K taps chain on the tensor cores,
    then the chain's sum adds to the float32 total."""
    rows = x.shape[0]
    xp = np.zeros((rows, T + K - 1, D), np.float32)
    xp[:, padl : padl + T] = x
    acc = np.zeros((rows * T, D), np.float32)
    for c0 in range(0, D, kc):
        chain = sum(_products(xp[:, j : j + T, c0 : c0 + kc].reshape(rows * T, kc),
                              w[j, c0 : c0 + kc], terms).astype(np.float64)
                    for j in range(K))
        acc = np.float32(acc + np.float32(chain))
    return np.float32(acc + b).reshape(rows, T, D)


def weight_grad_tc(x, g, padl, terms=3, chain_pairs=32):
    """dW[j] = sum_(r, t) x[r, t + j - padl]^T g[r, t] as the kernel runs it:
    chains of ``chain_pairs`` (row, t) pairs on the tensor cores, their sums
    added in float32."""
    rows = x.shape[0]
    xp = np.zeros((rows, T + K - 1, D), np.float32)
    xp[:, padl : padl + T] = x
    g2 = g.reshape(rows * T, D)
    out = []
    for j in range(K):
        xj = xp[:, j : j + T].reshape(rows * T, D)
        acc = np.zeros((D, D), np.float32)
        for p0 in range(0, rows * T, chain_pairs):
            acc = np.float32(acc + _products(xj[p0 : p0 + chain_pairs].T, g2[p0 : p0 + chain_pairs],
                                             terms))
        out.append(acc)
    return np.stack(out)


def _inputs(rows, seed):
    rng = np.random.default_rng(seed)
    bound = np.sqrt(6.0 / (2 * K * D))
    x = rng.standard_normal((rows, T, D)).astype(np.float32)
    w = rng.uniform(-bound, bound, (K, D, D)).astype(np.float32)
    b = (0.1 * rng.standard_normal(D)).astype(np.float32)
    return x, w, b


def _err(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max()


# (left pad, what the kernels use it for)
PADDINGS = {2: "causal conv", 1: "same-padded conv", 0: "input gradient of a causal conv"}


@pytest.mark.parametrize("padl", sorted(PADDINGS))
def test_3xtf32_conv_matches_float64_oracles(padl):
    x, w, b = _inputs(rows=6, seed=padl)
    if padl == 0:
        # the input gradient: the reversed, transposed taps with the causal
        # conv's padding swapped
        wt = np.ascontiguousarray(np.transpose(w[::-1], (0, 2, 1)))
        got = conv_tc(x, wt, np.zeros(D, np.float32), padl)
        oracle = attn_pallas._tconv_bwd_input(jnp.asarray(x, jnp.float64),
                                              jnp.asarray(w, jnp.float64), True, jnp.float64)
        want = attn._tconv_bwd_input_plain(torch.tensor(x).double(), torch.tensor(w).double(),
                                           True).numpy()
        assert _err(np.asarray(oracle), want) <= 1e-6
    else:
        causal = padl == 2
        got = conv_tc(x, w, b, padl)
        oracle = attn_pallas._tconv_ref(jnp.asarray(x, jnp.float64), jnp.asarray(w, jnp.float64),
                                        jnp.asarray(b, jnp.float64), causal, jnp.float64)
        want = attn.temporal_conv_plain(torch.tensor(x), torch.tensor(w), torch.tensor(b), causal,
                                        torch.float64).numpy()
        assert _err(np.asarray(oracle), want) <= 1e-12
    assert got.shape == want.shape and _err(got, want) <= TOL


def test_3xtf32_weight_gradient_matches_float64_oracles():
    rows = 344  # 4128 (row, t) pairs
    x, _, _ = _inputs(rows, seed=7)
    g = np.random.default_rng(8).standard_normal((rows, T, D)).astype(np.float32)
    for padl, causal in ((2, True), (1, False)):
        got = weight_grad_tc(x, g, padl)
        oracle, _ = attn_pallas._conv_weight_grads(jnp.asarray(x, jnp.float64),
                                                   jnp.asarray(g, jnp.float64), K, causal,
                                                   jnp.float64)
        want, _ = attn._conv_weight_grads_plain(torch.tensor(x).double(), torch.tensor(g).double(),
                                                K, causal)
        assert _err(np.asarray(oracle), want.numpy()) <= 1e-6
        assert _err(got, want.numpy()) <= TOL


def test_one_tf32_product_misses_the_tolerance():
    x, w, b = _inputs(rows=6, seed=9)
    want = attn.temporal_conv_plain(torch.tensor(x), torch.tensor(w), torch.tensor(b), True,
                                    torch.float64).numpy()
    assert _err(conv_tc(x, w, b, 2), want) <= TOL
    assert _err(conv_tc(x, w, b, 2, terms=1), want) > 10 * TOL
    rng = np.random.default_rng(10)
    x, g = (rng.standard_normal((344, T, D)).astype(np.float32) for _ in range(2))
    want, _ = attn._conv_weight_grads_plain(torch.tensor(x).double(), torch.tensor(g).double(), K,
                                            True)
    assert _err(weight_grad_tc(x, g, 2), want.numpy()) <= TOL
    assert _err(weight_grad_tc(x, g, 2, terms=1), want.numpy()) > 10 * TOL


def test_tf32_rounding():
    # ties away from zero at the 13th bit; exact TF32 values unchanged
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    vals = np.array([1.0, 1 + 2.0 ** -11, 1 + 3 * 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12,
                     1 + ulp], np.float32)
    want = np.array([1.0, 1 + ulp, 1 + 2 * ulp, -(1 + ulp), 1.0, 1 + ulp], np.float32)
    np.testing.assert_array_equal(tf32(vals), want)
    big, small = split(np.float32(np.pi))
    assert tf32(big) == big and truncate(small) == small
    assert abs(np.float64(big) + small - np.pi) < 2.0 ** -21 * one
