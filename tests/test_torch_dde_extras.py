"""The DDE extras of the port against the JAX package in float64:
``ddeint_adjoint`` on tests/functional/test_ddeint.py's adjoint problem
(rk4, 9 points): solution, weight gradient and lag gradient, with the
control that must fail (``odeint_adjoint`` without ``y_lags`` among its
parameters gives no lag gradient); ``ddeint_mos`` for euler, midpoint and
rk4, a tensor lag, a callable lag and a clamp violation (tau < h), values
and gradients; and ``ddeint_mos``'s validation errors, text for text."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddlexde_tpu as pxt
from paddlexde_tpu_torch import ddeint_adjoint, ddeint_mos, history_index, odeint_adjoint


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch compute thread per worker (the suite runs 6 workers on 8
    cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _x64():
    """Both sides in float64; restore the suite's x64 setting afterwards."""
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", before)


TOL = 1e-10


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(1.0, np.abs(want).max()))


def test_ddeint_adjoint_matches_jax_with_the_lag_gradient():
    # tests/functional/test_ddeint.py:17-24 and :94-119
    b, t_len, d = 3, 48, 4
    rng = np.random.RandomState(0)
    his, his_span = rng.randn(b, t_len, d), np.arange(t_len, dtype=np.float64)
    lags, y0 = np.asarray([3.2, 10.7, 25.0, 40.9]), rng.randn(b, 1, d)
    t_span = np.linspace(0.0, 1.0, 9)
    w0 = np.random.RandomState(2).randn(d, d) * 0.3

    def loss_jax(w, lg):
        sol, _ = pxt.ddeint_adjoint(
            lambda y_lags, y: jnp.tanh(jnp.mean(y_lags, axis=1, keepdims=True) @ w + y),
            jnp.asarray(y0), t_span, lg, jnp.asarray(his), jnp.asarray(his_span), "rk4")
        return jnp.sum(sol**2), sol

    (_, sol_j), (gw_j, gl_j) = jax.jit(jax.value_and_grad(loss_jax, argnums=(0, 1),
                                                          has_aux=True))(jnp.asarray(w0),
                                                                         jnp.asarray(lags))

    w = torch.tensor(w0, requires_grad=True)
    lg = torch.tensor(lags, requires_grad=True)
    sol, y_lags = ddeint_adjoint(
        lambda y_lags, y: torch.tanh(y_lags.mean(dim=1, keepdim=True) @ w + y),
        torch.tensor(y0), torch.tensor(t_span), lg, torch.tensor(his),
        torch.tensor(his_span), "rk4", adjoint_params=(w,))
    assert y_lags.shape == (b, 4, d)
    gw, gl = torch.autograd.grad((sol**2).sum(), [w, lg])
    _close(sol.detach(), sol_j)
    _close(gw, gw_j)
    _close(gl, gl_j)
    assert np.abs(np.asarray(gl_j)).max() > 1e-3

    # the control: odeint_adjoint over the same field without y_lags among
    # the parameters gives the lags no gradient
    lg2 = torch.tensor(lags, requires_grad=True)
    yl2 = history_index(lg2, torch.tensor(his), torch.tensor(his_span))
    sol2 = odeint_adjoint(
        lambda t, y: torch.tanh(yl2.mean(dim=1, keepdim=True) @ w + y) - 1e-3 * y,
        torch.tensor(y0), torch.tensor(t_span), "rk4", options={"interp": "linear"},
        adjoint_params=(w,))
    _close(sol2.detach(), sol_j)
    (gl2,) = torch.autograd.grad((sol2**2).sum(), [lg2], allow_unused=True)
    gl2 = torch.zeros_like(lg2) if gl2 is None else gl2
    with pytest.raises(AssertionError):
        _close(gl2, gl_j)


def _field(lib):
    sin, cos = (jnp.sin, jnp.cos) if lib is jnp else (torch.sin, torch.cos)
    return lambda t, y, yl: -0.9 * yl[..., 0, :] + 0.3 * yl[..., -1, :] + 0.1 * sin(y) + 0.05 * cos(t)


def test_ddeint_mos_matches_jax():
    rng = np.random.RandomState(0)
    his_span = np.linspace(-2.0, 0.0, 9)
    his = rng.randn(2, 9, 2) * 0.3 + 1.0
    y0, ts, taus = his[:, -1], np.linspace(0.0, 2.0, 5), [0.93, 1.37]
    # (JAX, port) callable lags: one state-dependent, one below h (clamped
    # to the newest knot)
    callable_lags = (
        lambda t, y: jnp.stack([1.1 + 0.3 * jnp.tanh(jnp.mean(y)), 0.1 + 0.01 * jnp.mean(y)]),
        lambda t, y: torch.stack([1.1 + 0.3 * torch.tanh(y.mean()), 0.1 + 0.01 * y.mean()]),
    )
    # (solver, lags); JAX's ddeint_mos reads t_span and the lags on the host,
    # so its side runs eagerly (no jit)
    cases = [("euler", "tensor"), ("midpoint", "tensor"), ("rk4", "tensor"),
             ("rk4", "callable")]
    for solver, kind in cases:
        def loss_jax(w, hh, tau=None):
            lags = tau if kind == "tensor" else callable_lags[0]
            sol = pxt.ddeint_mos(lambda t, y, yl: w * _field(jnp)(t, y, yl), jnp.asarray(y0),
                                 ts, lags, hh, his_span, solver=solver, step_size=0.25,
                                 time_axis=0)
            return jnp.sum(sol**2), sol

        args = (1.3, jnp.asarray(his)) + ((jnp.asarray(taus),) if kind == "tensor" else ())
        fn = jax.value_and_grad(loss_jax, argnums=tuple(range(len(args))), has_aux=True)
        (_, sol_j), grads_j = fn(*args)

        w = torch.tensor(1.3, dtype=torch.float64, requires_grad=True)
        hh = torch.tensor(his, requires_grad=True)
        tau = torch.tensor(taus, dtype=torch.float64, requires_grad=True)
        lags = tau if kind == "tensor" else callable_lags[1]
        sol = ddeint_mos(lambda t, y, yl: w * _field(torch)(t, y, yl), torch.tensor(y0), ts,
                         lags, hh, his_span, solver=solver, step_size=0.25, time_axis=0)
        grads = torch.autograd.grad((sol**2).sum(), [w, hh, tau][: len(args)])
        assert sol.shape == (5, 2, 2), (solver, kind)
        _close(sol.detach(), sol_j)
        for g, g_j in zip(grads, grads_j):
            _close(g, g_j)
            assert np.abs(np.asarray(g_j)).max() > 1e-3, (solver, kind)
    # rk4 on a lag-aligned grid is exact: y' = -y(t - 1), phi == 1, y(2) = -0.5
    sol = ddeint_mos(lambda t, y, yl: -yl[..., 0, :], torch.ones(1, dtype=torch.float64),
                     np.linspace(0.0, 2.0, 5), [1.0], torch.ones(9, 1, dtype=torch.float64),
                     his_span, solver="rk4", step_size=0.05, time_axis=0)
    assert abs(sol[-1, 0].item() + 0.5) < 1e-10
    # a tensor lag's steps stack only the newest knots (24 steps, a window of
    # 8): the same values and gradients as the full stack of a callable lag
    outs = []
    for kind in ("tensor", "callable"):
        w = torch.tensor(1.3, dtype=torch.float64, requires_grad=True)
        tau = torch.tensor(taus, dtype=torch.float64, requires_grad=True)
        lags = tau if kind == "tensor" else (lambda t, y: tau)
        sol = ddeint_mos(lambda t, y, yl: w * _field(torch)(t, y, yl), torch.tensor(y0),
                         np.linspace(0.0, 6.0, 7), lags, torch.tensor(his), his_span,
                         solver="rk4", step_size=0.25, time_axis=0)
        outs.append([sol.detach(), *torch.autograd.grad((sol**2).sum(), [w, tau])])
    for a, b in zip(*outs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-14)


def test_ddeint_mos_validation_errors():
    span, ts = np.linspace(-2.0, 0.0, 9), np.linspace(0.0, 2.0, 5)
    base = dict(t_span=ts, lags=[1.0], his_span=span, solver="rk4", step_size=0.25)
    cases = [dict(t_span=ts[::-1].copy()), dict(step_size=-0.25),
             dict(lags=[0.1], step_size=0.5), dict(his_span=span - 1.0),
             dict(solver="dopri5"), dict(lags="rank-2")]
    for change in cases:
        kw = {**base, **change}
        run = {"jax": (jnp, jnp.ones, pxt.ddeint_mos), "torch": (torch, torch.ones, ddeint_mos)}
        msgs = {}
        for side, (lib, ones, solve) in run.items():
            lags = (lambda t, y, ones=ones: ones((2, 2))) if kw["lags"] == "rank-2" else kw["lags"]
            with pytest.raises(ValueError) as err:
                solve(lambda t, y, yl: -yl[..., 0, :], ones(1), kw["t_span"], lags,
                      ones((9, 1)), kw["his_span"], solver=kw["solver"],
                      step_size=kw["step_size"])
            msgs[side] = str(err.value).split(";")[0]  # the tails name vmap / no vmap
        assert msgs["torch"] == msgs["jax"], change
