"""history_index, the fixed-grid solvers and ddeint of the port against the
JAX package, float64 to 1e-10 (same formulas; only reduction order can
differ)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddlexde_tpu as pxt
from paddlexde_tpu.functional.solve import integrate_term as jax_integrate
from paddlexde_tpu.xde.term import ode_term as jax_ode_term
from paddlexde_tpu_torch import SolverSpec, ddeint, history_index, integrate_term, ode_term


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs 6 workers on 8 cores: torch's default of one compute
    thread per core in each worker (spinning between the tiny ops here)
    would take cores from the JAX tests beside it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


TOL = 1e-10


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(1.0, np.abs(want).max()))


def _history(seed=0, shape=(2, 3), T=40, D=2):
    rng = np.random.RandomState(seed)
    his = rng.randn(*shape, T, D)
    span = np.arange(T, dtype=np.float64) * 0.5
    lags = np.concatenate([np.sort(rng.rand(8)) * span[-1], [span[-1], span[-1] - 0.2, -1.0]])
    return his, span, lags


@pytest.mark.parametrize("interpolation", ["linear", "cubic", "bezier"])
def test_history_index_and_lag_gradient(interpolation):
    his, span, lags = _history()
    w = np.random.RandomState(1).randn(*his.shape[:-2], lags.size, his.shape[-1])

    def jloss(lags_):
        y = pxt.history_index(lags_, jnp.asarray(his), jnp.asarray(span),
                              interpolation=interpolation)
        return jnp.sum(y * w), y

    (_, want), want_grad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(lags))
    lt = torch.tensor(lags, requires_grad=True)
    got = history_index(lt, torch.tensor(his), torch.tensor(span), interpolation=interpolation)
    (got * torch.tensor(w)).sum().backward()
    _close(got.detach().numpy(), want)
    _close(lt.grad.numpy(), want_grad)


def _field_torch(y_lags, y):
    """A closed-form DDE field: linear in y plus a smooth lag summary."""
    return -0.7 * y + 0.3 * torch.sin(y_lags.mean(dim=-2, keepdim=True))


def _field_jax(y_lags, y):
    return -0.7 * y + 0.3 * jnp.sin(y_lags.mean(axis=-2, keepdims=True))


@pytest.mark.parametrize("solver", ["euler", "rk4"])
@pytest.mark.parametrize("interp,step", [("", None), ("linear", 0.15), ("cubic", 0.15)])
def test_ddeint_matches_jax(solver, interp, step):
    his, span, lags = _history(seed=2)
    y0 = his[..., -1:, :] + 0.0
    t_span = np.linspace(0.0, 1.0, 5)
    options = None if step is None else {"step_size": step}
    want, want_lags = pxt.ddeint(
        _field_jax, jnp.asarray(y0), jnp.asarray(t_span), jnp.asarray(lags), jnp.asarray(his),
        jnp.asarray(span), solver, options=options, fixed_solver_interp=interp,
    )
    got, got_lags = ddeint(
        _field_torch, torch.tensor(y0), torch.tensor(t_span), torch.tensor(lags), torch.tensor(his),
        torch.tensor(span), solver, options=options, fixed_solver_interp=interp,
    )
    _close(got_lags.numpy(), want_lags)
    _close(got.numpy(), want)


@pytest.mark.parametrize("solver", ["euler", "midpoint", "rk4"])
def test_reverse_time_ode_matches_jax_and_closed_form(solver):
    y0 = np.array([1.0, -2.0, 0.5])
    t_span = np.array([1.0, 0.7, 0.2, 0.0])
    want = jax_integrate(jax_ode_term(lambda t, y: -y), jnp.asarray(y0), jnp.asarray(t_span),
                         solver, time_axis=0, options={"step_size": 0.05})
    got = integrate_term(ode_term(lambda t, y: -y), torch.tensor(y0), torch.tensor(t_span),
                         solver, time_axis=0, options={"step_size": 0.05})
    _close(got.numpy(), want)
    exact = y0[None] * np.exp(-(t_span - t_span[0]))[:, None]
    rel = np.abs(got.numpy() - exact).max() / np.abs(exact).max()
    assert rel < {"euler": 5e-2, "midpoint": 1e-3, "rk4": 1e-7}[solver]  # order 1 / 2 / 4 at h=0.05


def test_solver_options_are_validated():
    term = ode_term(lambda t, y: -y)
    y0, ts = torch.ones(2, dtype=torch.float64), torch.linspace(0, 1, 3, dtype=torch.float64)
    with pytest.raises(ValueError, match="unknown solver option"):
        integrate_term(term, y0, ts, "euler", options={"stepsize": 0.1})
    with pytest.raises(ValueError, match="unknown solver"):
        integrate_term(term, y0, ts, "eulr")
    # every solver name is ported: the DIRK solver runs, a spec of no engine raises
    assert torch.isfinite(integrate_term(term, y0, ts, "kvaerno3")).all()
    with pytest.raises(ValueError, match="unknown solver"):
        integrate_term(term, y0, ts, SolverSpec("made_up", "fixed", 1))
    with pytest.raises(ValueError, match="mutually exclusive"):
        integrate_term(term, y0, ts, "euler", options={"step_size": 0.1, "grid": ts})
