"""The port's CDE half against the JAX package, on the CPU, in float64.

``fill_forward``, ``NaturalCubicSpline`` (whose tridiagonal solve is the
port's cyclic reduction where JAX calls LAPACK ``gtsv``),
``rectilinear_interpolation``, ``cdeint`` (forward on every control
family, dopri5 with equal step counts, and the parameter gradient by
autograd and by ``adjoint=True``), the log-signatures and ``cdeint_logode``
at depths 1-3. Inputs are made from a numpy seed. Tolerances (relative to
the compared quantity's scale):

- interpolation and the log-signatures: 1e-12 (``fill_forward`` bit for
  bit);
- cdeint values and gradients, ``cdeint_logode``: 1e-10;
- dopri5: equal accepted and rejected steps, values DOPRI5_TOL. Its field
  is products and sums over a smooth control (a natural spline through
  sinusoids): over the kinks of a cubic Hermite control's derivative the
  two step controllers reject near their thresholds and part at the
  rounding of an error estimate (XLA contracts products and sums into
  FMAs), and their solutions then differ at the rtol level. The accepted
  steps' sizes follow the error estimates continuously, so the values
  differ by more than the fixed-grid solves' (measured 1e-11..2e-9).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddlexde_tpu as pj
from paddlexde_tpu import interpolation as ji
import paddlexde_tpu_torch as pt
from paddlexde_tpu_torch import interpolation as pi

F64 = torch.float64
INTERP_TOL = 1e-12
CDE_TOL = 1e-10
DOPRI5_TOL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def _float64_one_thread():
    x64, threads = jax.config.jax_enable_x64, torch.get_num_threads()
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(1)
    yield
    jax.config.update("jax_enable_x64", x64)
    torch.set_num_threads(threads)


def _rel(want, got):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.max(np.abs(want - got)) / max(np.max(np.abs(want)), 1e-300))


def _check_interpolation_extras():
    rng = np.random.default_rng(0)
    errs = []
    @jax.jit
    def natural(x, t, q):
        js = ji.NaturalCubicSpline(x, t)
        return js._m2, js.evaluate(q), js.derivative(q), js.evaluate(0.7 * t[-1])

    for n in (2, 3, 5, 64, 257):
        t = np.sort(rng.uniform(0.0, 3.0, n))
        t[0] = 0.0
        x = rng.normal(size=(2, 3, n, 4))
        q = np.linspace(0.0, t[-1], 41)
        ps = pi.NaturalCubicSpline(torch.tensor(x), torch.tensor(t))
        got = (ps._m2, ps.evaluate(torch.tensor(q)), ps.derivative(torch.tensor(q)),
               ps.evaluate(float(0.7 * t[-1])))
        errs += [_rel(w, g) for w, g in zip(natural(x, t, q), got)]
    x = rng.normal(size=(2, 6, 3))
    x[..., 0] = np.sort(rng.uniform(0.0, 1.0, 6))
    j_rect, j_knots = ji.rectilinear_interpolation(x)
    p_rect, p_knots = pi.rectilinear_interpolation(torch.tensor(x))
    q = np.linspace(0.0, 10.0, 23)
    errs += [_rel(j_rect.evaluate(q), p_rect.evaluate(torch.tensor(q))),
             _rel(j_rect.derivative(q), p_rect.derivative(torch.tensor(q))),
             _rel(j_knots, p_knots)]
    assert max(errs) <= INTERP_TOL
    s = rng.normal(size=(3, 7, 2))
    s[0, :2, 0] = np.nan
    s[1, 3, :] = np.nan
    s[2, :, 1] = np.nan
    mask = rng.uniform(size=(3, 7, 2)) > 0.5
    assert np.array_equal(np.asarray(ji.fill_forward(s)), pi.fill_forward(torch.tensor(s)).numpy(),
                          equal_nan=True)
    assert np.array_equal(np.asarray(ji.fill_forward(s, mask)),
                          pi.fill_forward(torch.tensor(s), torch.tensor(mask)).numpy(),
                          equal_nan=True)


def _cde_problem(rng, b=3, n_obs=9, c=3, hidden=4):
    x = rng.normal(size=(b, n_obs, c)).cumsum(1) * 0.3
    tx = np.sort(rng.uniform(0.0, 1.0, n_obs))
    tx[0], tx[-1] = 0.0, 1.0
    w1 = rng.normal(size=(hidden, 8)) * 0.4
    w2 = rng.normal(size=(8, hidden * c)) * 0.4
    y0 = rng.normal(size=(b, hidden))
    return x, tx, w1, w2, y0


def _check_cdeint_forward_and_both_gradients():
    rng = np.random.default_rng(1)
    x, tx, w1, w2, y0 = _cde_problem(rng)
    hidden, c = w1.shape[0], x.shape[-1]

    def field(tanh, p):
        return lambda t, y: tanh(tanh(y @ p[0]) @ p[1]).reshape(y.shape[:-1] + (hidden, c))

    grid = np.linspace(0.0, 1.0, 17)
    errs = []
    for j_cls, p_cls in ((ji.CubicHermiteSpline, pi.CubicHermiteSpline),
                         (ji.NaturalCubicSpline, pi.NaturalCubicSpline),
                         (ji.LinearInterpolation, pi.LinearInterpolation)):
        want = pj.cdeint(field(jnp.tanh, (w1, w2)), jnp.asarray(y0), jnp.asarray(grid),
                         j_cls(x, tx), "rk4", time_axis=0)
        got = pt.cdeint(field(torch.tanh, (torch.tensor(w1), torch.tensor(w2))),
                        torch.tensor(y0), torch.tensor(grid), p_cls(torch.tensor(x), torch.tensor(tx)),
                        "rk4", time_axis=0)
        errs.append(_rel(want, got))

    # dopri5 on a field of products and sums over a smooth control (a
    # natural spline through sinusoids)
    ts = np.linspace(0.0, 1.0, 9)
    xs = np.sin(2 * np.pi * rng.uniform(0.5, 1.5, (3, 1, c)) * ts[:, None]
                + rng.uniform(0.0, 6.0, (3, 1, c)))

    def poly(p):
        return lambda t, y: (0.5 * (y @ p[0]) * (1.0 - 0.1 * (y @ p[0])) @ p[1]).reshape(
            y.shape[:-1] + (hidden, c))

    span = np.array([0.0, 0.5, 1.0])
    want, j_stats = pj.cdeint(poly((w1, w2)), jnp.asarray(y0), jnp.asarray(span),
                              ji.NaturalCubicSpline(xs, ts), "dopri5", rtol=1e-8, atol=1e-10,
                              time_axis=0, options={"return_stats": True})
    got, p_stats = pt.cdeint(poly((torch.tensor(w1), torch.tensor(w2))), torch.tensor(y0),
                             torch.tensor(span),
                             pi.NaturalCubicSpline(torch.tensor(xs), torch.tensor(ts)), "dopri5",
                             rtol=1e-8, atol=1e-10, time_axis=0, options={"return_stats": True})
    assert (int(j_stats.n_accept), int(j_stats.n_reject)) == (int(p_stats.n_accept),
                                                              int(p_stats.n_reject))
    assert _rel(want, got) <= DOPRI5_TOL

    # the parameter gradient of |y(1)|^2, by autograd and by the adjoint
    def j_loss(p, adjoint):
        sol = pj.cdeint(field(jnp.tanh, p), jnp.asarray(y0), jnp.asarray([0.0, 1.0]),
                        ji.CubicHermiteSpline(x, tx), "rk4", options={"grid": jnp.asarray(grid)},
                        adjoint=adjoint, time_axis=0)
        return jnp.sum(sol[-1] ** 2)

    for adjoint in (False, True):
        want = jax.grad(j_loss)((jnp.asarray(w1), jnp.asarray(w2)), adjoint)
        p = [torch.tensor(w1, requires_grad=True), torch.tensor(w2, requires_grad=True)]
        sol = pt.cdeint(field(torch.tanh, p), torch.tensor(y0), torch.tensor([0.0, 1.0], dtype=F64),
                        pi.CubicHermiteSpline(torch.tensor(x), torch.tensor(tx)), "rk4",
                        options={"grid": torch.tensor(grid)}, adjoint=adjoint, time_axis=0,
                        **({"adjoint_params": p} if adjoint else {}))
        got = torch.autograd.grad((sol[-1] ** 2).sum(), p)
        errs += [_rel(w, g) for w, g in zip(want, got)]
    assert max(errs) <= CDE_TOL, errs


def test_interpolation_and_cdeint_match_jax():
    """The splines, then cdeint (one item: the suite's ``--dist load``
    chunks move with the item count, ROADMAP "Test placement")."""
    _check_interpolation_extras()
    _check_cdeint_forward_and_both_gradients()


def test_logsignatures_and_logode_match_jax():
    rng = np.random.default_rng(2)
    xs = rng.normal(size=(2, 12, 3)).cumsum(1) * 0.2
    errs = []
    for name in ("piecewise_logsignature", "piecewise_signature3", "piecewise_logsignature3"):
        for want, got in zip(getattr(pj, name)(xs), getattr(pt, name)(torch.tensor(xs))):
            errs.append(_rel(want, got))
    t12 = np.sort(rng.uniform(0.0, 2.0, 12))
    t12[0] = 0.0
    for kw in ({"knots_per_window": 4}, {"window": 0.5}):
        for want, got in zip(pj.logsignature_windows(xs, t12, **kw),
                             pt.logsignature_windows(torch.tensor(xs), torch.tensor(t12), **kw)):
            errs.append(_rel(want, got))
    assert max(errs) <= INTERP_TOL

    # the log-ODE demo's non-commuting linear field, and a batched
    # nonlinear one, over a 64-knot random walk
    n_knots = 64
    tk = np.linspace(0.0, 1.0, n_knots + 1)
    ts = np.linspace(0.0, 1.0, 5)
    b1 = np.array([[0.0, 1.0], [0.0, 0.0]]) * 0.8
    b2 = np.array([[0.0, 0.0], [1.0, 0.0]]) * 0.8
    wn = rng.normal(size=(2, 4)) * 0.5
    problems = [
        (lambda t, y: jnp.stack([y @ b1.T, y @ b2.T], axis=-1),
         lambda t, y: torch.stack([y @ torch.tensor(b1).T, y @ torch.tensor(b2).T], dim=-1),
         rng.normal(size=(n_knots + 1, 2)).cumsum(0) * 0.05, np.array([1.0, 0.5])),
        (lambda t, y: jnp.tanh(y @ wn).reshape(y.shape[:-1] + (2, 2)),
         lambda t, y: torch.tanh(y @ torch.tensor(wn)).reshape(y.shape[:-1] + (2, 2)),
         rng.normal(size=(3, n_knots + 1, 2)).cumsum(1) * 0.05, rng.normal(size=(3, 2))),
    ]
    errs = []
    for j_f, p_f, x, y0 in problems:
        for depth in (1, 2, 3):
            want = pj.cdeint_logode(j_f, jnp.asarray(y0), jnp.asarray(ts), (x, tk), depth=depth,
                                    substeps=2, time_axis=0)
            got = pt.cdeint_logode(p_f, torch.tensor(y0), torch.tensor(ts),
                                   (torch.tensor(x), torch.tensor(tk)), depth=depth, substeps=2,
                                   time_axis=0)
            errs.append(_rel(want, got))
    assert max(errs) <= CDE_TOL, errs
