"""The history lookup at two query sets (``hermite_gather_eval_pair``), its
fused lag gradient and the CUDA kernel's segment search, on the CPU.

The pair is held against two calls of the JAX package's plain reference
(``spline_pallas.hermite_gather_eval(..., use_pallas=False)``) and its lag
gradients against ``jax.grad``, in float64 to 1e-12, over the five cases of
``tests/test_torch_spline.py``. The kernel (``csrc/spline.cu``) finds each
query's segment with one warp: a window of knots around an interpolated
guess, then a 64-ary search where the window misses; a numpy emulation of
that search is held against ``torch.searchsorted``, with controls (probes one
knot off, a left-sided comparison) that must fail.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlexde_tpu.ops import spline_pallas
from paddlexde_tpu_torch.interpolation import CubicHermiteSpline
from paddlexde_tpu_torch.ops import spline

TOL = 1e-12  # float64: the same formulas, sums in another order


@pytest.fixture(autouse=True, scope="module")
def _float64_one_thread():
    """JAX in float64 (another test may have turned x64 off), and one torch
    thread: the suite runs 6 workers on 8 cores."""
    x64, threads = jax.config.jax_enable_x64, torch.get_num_threads()
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(1)
    yield
    jax.config.update("jax_enable_x64", x64)
    torch.set_num_threads(threads)


def _cases():
    """``tests/test_torch_spline.py``'s five cases (knots, queries) at T = 24,
    each set repeated to 12 queries (one shape: JAX compiles once), with a
    second set: the first reversed and moved by 0.375."""
    uniform = np.arange(24, dtype=np.float64)
    duplicate = uniform.copy()
    duplicate[5] = duplicate[4]
    fractional = np.sort(np.random.RandomState(3).rand(12)) * 23
    cases = {
        "on_knots": (uniform, np.array([0.0, 1.0, 5.0, 22.0, 23.0])),
        "last_interval": (uniform, np.array([22.25, 22.5, 22.99, 23.0])),
        "out_of_range": (uniform, np.array([-3.5, -0.25, 23.5, 28.0])),
        "fractional": (uniform, fractional),
        "duplicate_knots": (duplicate, np.array([1.5, 3.5, 4.0, 4.5, 5.5, 9.25])),
    }
    cases = {name: (t, np.resize(qa, 12)) for name, (t, qa) in cases.items()}
    return {name: (t, qa, qa[::-1] + 0.375) for name, (t, qa) in cases.items()}


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(1.0, np.nanmax(np.abs(want))))


def _jax_loss(qa, qb, series, t, wa, wb):
    ya = spline_pallas.hermite_gather_eval(series, t, qa, False)
    yb = spline_pallas.hermite_gather_eval(series, t, qb, False)
    return jnp.sum(ya * wa) + jnp.sum(yb * wb), (ya, yb)


def test_pair_and_its_lag_gradients_match_jax():
    """Every case: both outputs of the pair against two JAX calls, both lag
    gradients against ``jax.grad`` of the same loss (one compilation: every
    case has the same shapes)."""
    jgrad = jax.jit(jax.grad(_jax_loss, argnums=(0, 1), has_aux=True))
    rng = np.random.RandomState(0)
    for name, (t, qa, qb) in _cases().items():
        series = rng.randn(2, 3, t.size, 3)
        wa, wb = rng.randn(2, 3, qa.size, 3), rng.randn(2, 3, qb.size, 3)
        (want_ga, want_gb), (want_a, want_b) = jgrad(*map(jnp.asarray, (qa, qb, series, t, wa, wb)))
        qa_t, qb_t = (torch.tensor(q, requires_grad=True) for q in (qa, qb))
        st = torch.tensor(series, requires_grad=True)
        ya, yb = spline.hermite_gather_eval_pair(st, torch.tensor(t), qa_t, qb_t)
        ((ya * torch.tensor(wa)).sum() + (yb * torch.tensor(wb)).sum()).backward()
        for got, want in ((ya.detach(), want_a), (yb.detach(), want_b), (qa_t.grad, want_ga),
                          (qb_t.grad, want_gb)):
            _close(got.numpy(), want)
        assert st.grad is None, name  # no gradient to the history (HistoryIndex contract)


def test_fused_plain_lag_gradient_matches_autograd():
    """``lag_grad_plain`` (the derivative basis times g, summed) against
    autograd through the spline class, every case and both query sets."""
    rng = np.random.RandomState(1)
    for name, (t, qa, qb) in _cases().items():
        series = torch.tensor(rng.randn(2, 3, t.size, 3))
        for q in (qa, qb):
            g = torch.tensor(rng.randn(2, 3, q.size, 3))
            qt = torch.tensor(q, requires_grad=True)
            (CubicHermiteSpline(series, torch.tensor(t)).evaluate(qt) * g).sum().backward()
            _close(spline.lag_grad_plain(series, torch.tensor(t), torch.tensor(q), g).numpy(),
                   qt.grad.numpy())


def _warp_search(t, q, probe_shift=0, left=False):
    """The kernel's segment search (``locate`` and ``upper_bound_warp`` in
    ``csrc/spline.cu``) for the queries ``q``, each a warp of 32 lanes: a
    window of 64 knots around the index that linear interpolation between
    t[0] and t[n-1] guesses, then, where the window does not hold the answer,
    rounds that probe 64 knots evenly spaced over what is left. It finds the
    first j with t[j] > q (``left``: t[j] >= q, a control) and returns the
    segment ``clamp(j - 1, 0, T - 2)``. ``probe_shift`` moves every probe and
    the window by one knot (a control)."""
    n = t.size
    above = (lambda k, v: k >= v) if left else (lambda k, v: k > v)
    span = t[-1] - t[0]
    with np.errstate(invalid="ignore", divide="ignore"):
        g = (q - t[0]) / span * (n - 1) if span > 0 else np.zeros_like(q)
    g = np.where(g >= 0, np.minimum(g, n - 1), 0).astype(np.int64)
    w = np.maximum(0, np.minimum(g - 31, n - 64)) + probe_shift
    pos = w[:, None] + np.arange(64)
    ballot = (pos >= n) | above(t[pos.clip(0, n - 1)], q[:, None])
    f = np.where(ballot.any(axis=1), ballot.argmax(axis=1), 64)
    lo = np.where(f == 64, w + 64, np.where((f == 0) & (w > 0), 0, w + f))
    hi = np.where(f == 64, n, np.where((f == 0) & (w > 0), w, w + f))
    while (hi > lo).any():
        live = hi > lo
        step = (hi - lo + 63) >> 6
        lanes = lo[:, None] + (np.arange(64) + 1) * step[:, None] - 1 + probe_shift
        ballot = (lanes >= hi[:, None]) | above(t[lanes.clip(0, n - 1)], q[:, None])
        none, f = ~ballot.any(axis=1), ballot.argmax(axis=1)
        new_hi = np.where(none, hi, np.minimum(lo + (f + 1) * step - 1, hi))
        new_lo = np.where(none, hi, lo + f * step)
        lo, hi = np.where(live, new_lo, lo), np.where(live, new_hi, hi)
    return np.clip(lo - 1, 0, n - 2)


def test_warp_segment_search_matches_searchsorted():
    """The emulated search gives ``torch.searchsorted(t, q, right=True) - 1``
    clamped to [0, T - 2] at the knots, between them and outside, on evenly
    spaced knots (the window holds every answer), knots with repeats, and
    knots spaced as squares and as square roots (the search takes over past
    the window and before it), for T
    from 2 to past 64^2; the controls (probes and window one knot further, a
    left-sided comparison) must not."""
    rng = np.random.RandomState(2)
    wrong = {"probe_shift": 0, "left": 0}
    for t_len in (2, 3, 63, 64, 65, 100, 2016, 4097):
        for t in (np.arange(t_len, dtype=np.float64),
                  np.sort(rng.randint(0, 3, t_len).cumsum().astype(np.float64)),
                  np.arange(t_len, dtype=np.float64) ** 2, np.sqrt(np.arange(t_len))):
            q = np.concatenate([t, t + 0.5, t - 0.5, rng.uniform(t[0] - 2, t[-1] + 2, 64),
                                [t[0] - 10, t[-1] + 10, np.inf, -np.inf]])
            want = (torch.searchsorted(torch.tensor(t), torch.tensor(q), right=True) - 1).clamp(
                0, t_len - 2).numpy()
            np.testing.assert_array_equal(_warp_search(t, q), want, err_msg=f"T = {t_len}")
            wrong["probe_shift"] += (_warp_search(t, q, probe_shift=1) != want).sum()
            wrong["left"] += (_warp_search(t, q, left=True) != want).sum()
    assert all(wrong.values()), f"a control went unnoticed: {wrong}"
