"""Spline gather kernel K1 (plain version) and the port's CubicHermiteSpline
against the JAX package, float64 to 1e-12.

The JAX side runs its plain references (``use_pallas=False``; the JAX
package's own tests pin them against the interpret-mode Pallas kernel). The
CUDA kernel's own arithmetic (the segment from a right-sided search, slopes
from rows i, i+1, i2 = min(i+2, T-1)) is emulated here in torch, so its
index/clamp logic is pinned on the CPU too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlexde_tpu.interpolation import CubicHermiteSpline as JaxHermite
from paddlexde_tpu.ops import spline_pallas
from paddlexde_tpu_torch.interpolation import CubicHermiteSpline
from paddlexde_tpu_torch.ops import spline


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs 6 workers on 8 cores: torch's default of one compute
    thread per core in each worker (spinning between the tiny ops here)
    would take cores from the JAX tests beside it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


TOL = 1e-12  # float64: same formulas, same operation order


def _t_uniform(T):
    return np.arange(T, dtype=np.float64)


def _t_duplicate(T):
    t = np.arange(T, dtype=np.float64)
    t[5] = t[4]  # a repeated knot: zero-width interval, infinite slope
    return t


CASES = {
    # name: (knots, queries)
    "on_knots": (_t_uniform, lambda T: np.array([0.0, 1.0, 5.0, T - 2.0, T - 1.0])),
    "last_interval": (_t_uniform, lambda T: np.array([T - 1.75, T - 1.5, T - 1.01, T - 1.0])),
    "out_of_range": (_t_uniform, lambda T: np.array([-3.5, -0.25, T - 0.5, T + 4.0])),
    "fractional": (_t_uniform, lambda T: np.sort(np.random.RandomState(3).rand(12)) * (T - 1)),
    "duplicate_knots": (_t_duplicate, lambda T: np.array([1.5, 3.5, 4.0, 4.5, 5.5, 9.25])),
}


def _data(case, T=24, shape=(2, 3), D=3, seed=0):
    knots, queries = CASES[case]
    series = np.random.RandomState(seed).randn(*shape, T, D)
    return series, knots(T), queries(T).astype(np.float64)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(1.0, np.nanmax(np.abs(want))))


@pytest.mark.parametrize("case", sorted(CASES))
def test_gather_eval_matches_jax(case):
    series, t, q = _data(case)
    want = spline_pallas.hermite_gather_eval(jnp.asarray(series), jnp.asarray(t), jnp.asarray(q), False)
    got = spline.hermite_gather_eval(torch.tensor(series), torch.tensor(t), torch.tensor(q))
    _close(got.numpy(), want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_derivative_basis_matches_jax(case):
    series, t, q = _data(case)
    want = spline_pallas._gather_eval_impl(
        jnp.asarray(series), jnp.asarray(t), jnp.asarray(q), use_pallas=False, derivative=True
    )
    got = spline.gather_eval_plain(torch.tensor(series), torch.tensor(t), torch.tensor(q), True)
    _close(got.numpy(), want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_spline_class_matches_jax(case):
    series, t, q = _data(case)
    spl = JaxHermite(jnp.asarray(series), jnp.asarray(t))
    port = CubicHermiteSpline(torch.tensor(series), torch.tensor(t))
    _close(port.evaluate(torch.tensor(q)).numpy(), spl.evaluate(jnp.asarray(q)))
    _close(port.derivative(torch.tensor(q)).numpy(), spl.derivative(jnp.asarray(q)))


def _emulate_kernel(series, t, q, derivative):
    """The CUDA kernel's arithmetic, in torch: the segment from searchsorted,
    both slopes from rows i, i+1 and i2 = min(i+2, T-1)."""
    T = series.shape[-2]
    idx = (torch.searchsorted(t, q, right=True) - 1).clamp(0, T - 2)
    i2 = (idx + 2).clamp(max=T - 1)
    t0, t1 = t[idx], t[idx + 1]
    h = torch.where(t1 == t0, torch.ones_like(t0), t1 - t0)
    coef = torch.stack(spline._basis((q - t0) / h, h, derivative))[:, :, None]
    row = lambda i: series.index_select(-2, i)
    p0, p1, pa, pb = row(idx), row(idx + 1), row(i2 - 1), row(i2)
    m0 = (p1 - p0) / (t1 - t0)[:, None]
    m1 = (pb - pa) / (t[i2] - t[i2 - 1])[:, None]
    return coef[0] * p0 + coef[1] * m0 + coef[2] * p1 + coef[3] * m1


@pytest.mark.parametrize("derivative", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_arithmetic_reproduces_plain(case, derivative):
    series, t, q = _data(case)
    args = (torch.tensor(series), torch.tensor(t), torch.tensor(q), derivative)
    _close(_emulate_kernel(*args).numpy(), spline.gather_eval_plain(*args).numpy())


@pytest.mark.parametrize("case", ["fractional", "last_interval", "out_of_range"])
def test_lag_gradient_matches_jax_grad(case):
    series, t, q = _data(case)
    w = np.random.RandomState(7).randn(*series.shape[:-2], q.size, series.shape[-1])

    def jloss(q_):
        out = spline_pallas.hermite_gather_eval(jnp.asarray(series), jnp.asarray(t), q_, False)
        return jnp.sum(out * w)

    want = jax.grad(jloss)(jnp.asarray(q))
    qt = torch.tensor(q, requires_grad=True)
    st = torch.tensor(series, requires_grad=True)
    out = spline.hermite_gather_eval(st, torch.tensor(t), qt)
    (out * torch.tensor(w)).sum().backward()
    _close(qt.grad.numpy(), want)
    assert st.grad is None  # no gradient to the history (HistoryIndex contract)
