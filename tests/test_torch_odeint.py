"""The adaptive ODE path of the port against the JAX package, on the CPU.

``odeint`` on the explicit adaptive solvers (the per-output engine and the
buffered-dense one), ``odeint_dense``, direct gradients through the solve,
``odeint_adjoint``, the tableau constants, norms and step-control helpers,
and the spiral neural ODE of ``bench.py`` in float32. Each item runs its
cases in one test (the suite counts items, ROADMAP.md "Test placement").

The float64 comparisons use a vector field of products and sums only,
``(y @ W) * (1 + t/2) - y*y*y/5``, which XLA and PyTorch round alike, and
run the JAX side under ``jax.disable_jit`` (no fused multiply-adds): the
two engines then see the same stage values, and their step sequences and
``AdaptiveStats`` must be equal. A transcendental field differs by an ulp
between the libraries, and where an error estimate sits near rounding
level (dopri8's first steps) the grids then drift apart within the
tolerance, not bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddlexde_tpu as pj
from paddlexde_tpu.solver import tableaus as jax_tableaus
from paddlexde_tpu.utils import misc as jax_misc
from paddlexde_tpu.utils import norms as jax_norms
from paddlexde_tpu.utils import ode_utils as jax_ode_utils
import paddlexde_tpu_torch as pt
from paddlexde_tpu_torch.functional.odeint_adjoint import BACKWARD_STATS
from paddlexde_tpu_torch.solver import adaptive as pt_adaptive
from paddlexde_tpu_torch.solver import tableaus as pt_tableaus
from paddlexde_tpu_torch.utils import misc as pt_misc
from paddlexde_tpu_torch.utils import norms as pt_norms
from paddlexde_tpu_torch.utils import ode_utils as pt_ode_utils

F64 = torch.float64
VALUE_TOL = 1e-10  # float64 values, relative to the solution's scale
GRAD_TOL = 1e-8  # direct gradients, relative
ADJOINT_TOL = 1e-7  # adjoint gradients, relative
SPIRAL_TOL = 2e-5  # float32 spiral, relative to the solution's scale

# (method, rtol): each takes 8-16 steps over t in [0, 1] (the JAX side runs
# eagerly, ~40 ms a step)
METHODS = [("adaptive_heun", 1e-2), ("fehlberg2", 1e-4), ("bosh3", 1e-4),
           ("dopri5", 1e-8), ("dopri8", 1e-9), ("tsit5", 1e-8)]


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


RNG = np.random.RandomState(0)
W = RNG.randn(3, 3) * 0.5
Y0 = RNG.randn(2, 3)


def jax_field(w):
    return lambda t, y: (y @ w) * (1.0 + 0.5 * t) - 0.2 * y * y * y


def port_field(w):
    return lambda t, y: (y @ w) * (1.0 + 0.5 * t) - 0.2 * y * y * y


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def stats_of(s):
    return tuple(int(x) for x in (s.nfe, s.n_accept, s.n_reject, s.status))


def jax_solve(t, method, rtol, options, w=W, y0=Y0):
    with jax.disable_jit():
        ys, st = pj.odeint(jax_field(jnp.asarray(w)), jnp.asarray(y0), jnp.asarray(t), method,
                           rtol=rtol, atol=rtol * 1e-2, time_axis=0,
                           options=dict(options, return_stats=True))
    return np.asarray(ys), stats_of(st)


def port_solve(t, method, rtol, options, w=W, y0=Y0):
    ys, st = pt.odeint(port_field(torch.tensor(w)), torch.tensor(y0), torch.tensor(t), method,
                       rtol=rtol, atol=rtol * 1e-2, time_axis=0,
                       options=dict(options, return_stats=True))
    return ys.detach().numpy(), stats_of(st)


def test_tableaus_norms_and_step_control_match_jax():
    """Every tableau's constants (the implicit ones too) at 1e-14; the norms
    and their aliases on a tree, ``flat_to_shape``, and the step-control
    helpers (error ratio, step size, initial step, quartic fit and Horner
    evaluation, ``sort_tvals``) against the JAX functions in float64."""
    assert set(pt_tableaus.TABLEAUS) == set(jax_tableaus.TABLEAUS)
    for name, want in jax_tableaus.TABLEAUS.items():
        got = pt_tableaus.TABLEAUS[name]
        assert (got.order, got.n_stages, got.fsal, got.implicit) == (
            want.order, want.n_stages, want.fsal, want.implicit), name
        for field in ("alpha", "beta", "c_sol", "c_error", "c_mid", "diag"):
            a, b = getattr(got, field), getattr(want, field)
            assert (a is None) == (b is None), (name, field)
            if a is not None:
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-14, err_msg=f"{name}.{field}")

    rng = np.random.RandomState(1)
    tree = (rng.randn(3, 4), [rng.randn(5) * 1e-3, rng.randn(2, 2) * 10])
    ttree = (torch.tensor(tree[0]), [torch.tensor(x) for x in tree[1]])
    for name in ("linf_norm", "rms_norm", "zero_norm", "mixed_norm", "_linf_norm", "_rms_norm",
                 "_zero_norm", "_mixed_norm"):
        got = float(getattr(pt_norms, name)(ttree))
        want = float(getattr(jax_norms, name)(jax.tree.map(jnp.asarray, tree)))
        assert abs(got - want) <= 1e-14 * max(abs(want), 1.0), name

    flat = rng.randn(4, 2 + 6 + 1)
    shapes = [(2,), (2, 3), ()]
    for a, b in zip(pt_misc.flat_to_shape(torch.tensor(flat), (4,), shapes),
                    jax_misc.flat_to_shape(jnp.asarray(flat), (4,), shapes)):
        assert rel(a.numpy(), b) == 0.0

    y0, y1, ym, f0, f1 = (rng.randn(2, 3) for _ in range(5))
    coeff_j = jax_ode_utils.interp_fit(*map(jnp.asarray, (y0, y1, ym, f0, f1)), jnp.asarray(0.3))
    coeff_t = pt_ode_utils.interp_fit(*map(torch.tensor, (y0, y1, ym, f0, f1)),
                                      torch.tensor(0.3, dtype=F64))
    for a, b in zip(coeff_t, coeff_j):
        assert rel(a.numpy(), b) < 1e-15
    for t in (0.1, 0.25, 0.35):
        want = jax_ode_utils.interp_evaluate(coeff_j, 0.1, 0.35, jnp.asarray(t))
        got = pt_ode_utils.interp_evaluate(coeff_t, torch.tensor(0.1, dtype=F64),
                                           torch.tensor(0.35, dtype=F64),
                                           torch.tensor(t, dtype=F64))
        assert rel(got.numpy(), want) < 1e-15
    err = rng.randn(2, 3) * 1e-6
    for norm in ("rms_norm", "mixed_norm", "linf_norm"):
        want = jax_ode_utils.compute_error_ratio(jnp.asarray(err), 1e-5, 1e-7, jnp.asarray(y0),
                                                 jnp.asarray(y1), getattr(jax_norms, norm))
        got = pt_ode_utils.compute_error_ratio(torch.tensor(err), 1e-5, 1e-7, torch.tensor(y0),
                                               torch.tensor(y1), getattr(pt_norms, norm))
        assert abs(float(got) - float(want)) <= 1e-15 * float(want), norm
    for ratio in (0.0, 1e-9, 0.3, 1.0, 7.5, 1e12):
        for order in (2, 5, 8):
            want = jax_ode_utils.optimal_step_size(jnp.asarray(0.2), ratio, 0.9, 10.0, 0.2, order)
            got = pt_ode_utils.optimal_step_size(torch.tensor(0.2, dtype=F64), ratio, 0.9, 10.0,
                                                 0.2, order)
            assert abs(float(got) - float(want)) <= 1e-15, (ratio, order)
    for order in (1, 2, 4, 7):
        want = jax_ode_utils.select_initial_step(
            lambda t, dt, y: jax_field(jnp.asarray(W))(t, y), jnp.asarray(0.25),
            jnp.asarray(Y0), order, 1e-6, 1e-8)
        got = pt_ode_utils.select_initial_step(
            lambda t, dt, y: port_field(torch.tensor(W))(t, y), torch.tensor(0.25, dtype=F64),
            torch.tensor(Y0), order, 1e-6, 1e-8)
        assert abs(float(got) - float(want)) <= 1e-15 * float(want), order
    tv = np.array([3.0, -1.0, 0.5, 2.0])
    assert np.array_equal(pt_ode_utils.sort_tvals(torch.tensor(tv), 0.5).numpy(),
                          np.asarray(jax_ode_utils.sort_tvals(jnp.asarray(tv), 0.5)))


def test_adaptive_engines_match_jax():
    """Every explicit adaptive method, on the per-output engine and on the
    buffered-dense one (``max_steps``): AdaptiveStats equal to JAX's and
    values within VALUE_TOL. Also a decreasing span, ``step_t``/``jump_t``,
    two failing solves (``max_num_steps`` tiny; ``min_step`` large with a
    ``max_step`` below it) with their status bits, ``max_steps`` exceeded,
    ``odeint_dense`` values and derivatives inside and at the ends of a
    forward and a reversed span, and the one host read per attempted step."""
    t = np.linspace(0.0, 1.0, 4)
    failed = []
    for method, rtol in METHODS:
        want, want_stats = jax_solve(t, method, rtol, {})
        for options in ({}, {"max_steps": 256}):
            pt_adaptive.reset_host_reads()
            got, got_stats = port_solve(t, method, rtol, options)
            reads = pt_adaptive.HOST_READS["step"]
            case = f"{method} {options}: stats {got_stats} vs {want_stats}, err {rel(got, want):.2e}"
            if (got_stats != want_stats or rel(got, want) > VALUE_TOL
                    or reads != got_stats[1] + got_stats[2]):
                failed.append(case + f", reads {reads}")
    assert not failed, "\n".join(failed)

    cases = {
        "decreasing": (np.linspace(0.5, 0.0, 4), {}),
        "step_t and jump_t": (t, {"step_t": [0.3, 0.31, 0.8], "jump_t": [0.45, 0.6]}),
        "max_num_steps": (t, {"max_num_steps": 3}),
        "min_step > max_step": (t, {"min_step": 0.5, "max_step": 0.1}),
    }
    for name, (ts, options) in cases.items():
        want, want_stats = jax_solve(ts, "dopri5", 1e-7, options)
        got, got_stats = port_solve(ts, "dopri5", 1e-7, options)
        assert got_stats == want_stats, (name, got_stats, want_stats)
        assert rel(got, want) <= VALUE_TOL, (name, rel(got, want))
    _, st = port_solve(t, "dopri5", 1e-9, {"max_steps": 4})
    _, sj = jax_solve(t, "dopri5", 1e-9, {"max_steps": 4})
    assert st == sj and st[3] == 4, (st, sj)

    q = np.array([0.0, 0.1, 0.15, 0.25, 0.3, -0.1])
    for span in ((0.0, 0.25), (0.25, 0.0)):
        with jax.disable_jit():
            dj = pj.odeint_dense(jax_field(jnp.asarray(W)), jnp.asarray(Y0), jnp.asarray(span),
                                 "tsit5", rtol=1e-7, atol=1e-9)
            want_v, want_d = np.asarray(dj(jnp.asarray(q))), np.asarray(dj.derivative(jnp.asarray(q)))
        dt_ = pt.odeint_dense(port_field(torch.tensor(W)), torch.tensor(Y0),
                              torch.tensor(span, dtype=F64), "tsit5", rtol=1e-7, atol=1e-9)
        assert rel(dt_(torch.tensor(q)).numpy(), want_v) <= VALUE_TOL, span
        assert rel(dt_.derivative(torch.tensor(q)).numpy(), want_d) <= VALUE_TOL, span
        assert rel(dt_(torch.tensor(q[1], dtype=F64)).numpy(), want_v[1]) <= VALUE_TOL


def _grad_loss_weights(n_out):
    return np.random.RandomState(2).randn(n_out, *Y0.shape)


def test_direct_gradients_match_jax():
    """dopri5 gradients of ``sum(g * y(t))`` to y0, to a weight the field
    closes over and to ``t_span``, through the per-output engine and the
    buffered-dense one, against ``jax.grad`` through the JAX engine (its
    recorded-grid replay; compiled once, both spans have 4 outputs) within
    GRAD_TOL, over an increasing and a decreasing span; ``direct_grad=False``
    builds no graph; more accepted steps than ``grid_buffer`` warn."""

    def jax_loss(y0, w, ts, g):
        ys = pj.odeint(jax_field(w), y0, ts, "dopri5", rtol=1e-8, atol=1e-10, time_axis=0,
                       options={"grid_buffer": 20})
        return jnp.sum(ys * g)

    jax_grad = jax.jit(jax.grad(jax_loss, argnums=(0, 1, 2)))
    for t in (np.linspace(0.0, 1.0, 4), np.linspace(0.4, 0.0, 4)):
        g = _grad_loss_weights(t.size)
        want = jax_grad(*map(jnp.asarray, (Y0, W, t, g)))
        for options in ({}, {"max_steps": 64}):
            y0, w, ts = (torch.tensor(x, requires_grad=True) for x in (Y0, W, t))
            ys = pt.odeint(port_field(w), y0, ts, "dopri5", rtol=1e-8, atol=1e-10, time_axis=0,
                           options=options)
            (ys * torch.tensor(g)).sum().backward()
            for name, got, ref in zip(("y0", "w", "t_span"), (y0.grad, w.grad, ts.grad), want):
                assert rel(got.numpy(), ref) <= GRAD_TOL, (t[0], options, name,
                                                           rel(got.numpy(), ref))

    ys = pt.odeint(port_field(torch.tensor(W)), torch.tensor(Y0, requires_grad=True),
                   torch.tensor(t), "dopri5", options={"direct_grad": False})
    assert not ys.requires_grad
    with pytest.warns(RuntimeWarning, match="grid_buffer"):
        pt.odeint(port_field(torch.tensor(W)), torch.tensor(Y0, requires_grad=True),
                  torch.tensor(t), "dopri5", options={"grid_buffer": 2})


def _adjoint_case(t, solver, adjoint_options, options=None, t_grad=True):
    """Gradients of ``sum(g * y(t))`` by ``odeint_adjoint`` in both packages:
    [y0, w, t_span] (without ``t_span`` when ``t_grad`` is False: JAX then
    holds the span concrete, which its ``k_sub`` refinement needs)."""
    g = _grad_loss_weights(t.size)

    def jax_loss(y0, w, ts):
        ys = pj.odeint_adjoint(jax_field(w), y0, ts, solver, rtol=1e-4, atol=1e-6,
                               options=options, adjoint_options=adjoint_options, time_axis=0)
        return jnp.sum(ys * g)

    with jax.disable_jit():
        if t_grad:
            want = jax.grad(jax_loss, argnums=(0, 1, 2))(jnp.asarray(Y0), jnp.asarray(W),
                                                         jnp.asarray(t))
        else:
            want = jax.grad(lambda y0, w: jax_loss(y0, w, t), argnums=(0, 1))(
                jnp.asarray(Y0), jnp.asarray(W))
    y0, w, ts = (torch.tensor(x, requires_grad=True) for x in (Y0, W, t))
    ys = pt.odeint_adjoint(port_field(w), y0, ts, solver, rtol=1e-4, atol=1e-6,
                           options=options, adjoint_options=adjoint_options,
                           adjoint_params=(w,), time_axis=0)
    (ys * torch.tensor(g)).sum().backward()
    got = [y0.grad, w.grad, ts.grad][:len(want)]
    return [np.asarray(x) for x in want], [x.numpy() for x in got]


def test_odeint_adjoint_matches_jax():
    """Adjoint gradients to y0, a closed-over weight and ``t_span`` against
    the JAX adjoint within ADJOINT_TOL: the single-pass backward (dopri5,
    mixed norm and seminorm, increasing and decreasing spans), the
    per-interval path (a two-point span), the fixed-solver fallback with the
    forward grid's sub-steps (rk4 at step_size 0.25: ``k_sub`` = 2; both
    need a concrete span on the JAX side, so no ``t_span`` gradient); a
    failing backward (``max_num_steps``) gives NaN gradients in both
    packages, on both paths; the seminorm backward takes fewer field
    evaluations; ``adjoint_params`` missing for a closed-over tensor raises;
    symplectic solvers are refused."""
    t = np.linspace(0.0, 1.0, 4)
    nfe = {}
    cases = {
        "mixed": (t, "dopri5", None, None, True),
        "seminorm": (t, "dopri5", {"norm": "seminorm"}, None, True),
        # t_span concrete on the JAX side: its odeint_adjoint reads the
        # direction of a differentiated span as increasing (ROADMAP.md §3)
        "decreasing": (np.linspace(0.3, 0.0, 4), "dopri5", None, None, False),
        "two points": (np.array([0.0, 1.0]), "dopri5", {"norm": "seminorm"}, None, True),
        "rk4 k_sub": (np.array([0.0, 0.5, 1.0]), "rk4", None, {"step_size": 0.25}, False),
    }
    for name, (ts, solver, adj_opts, options, t_grad) in cases.items():
        want, got = _adjoint_case(ts, solver, adj_opts, options, t_grad)
        nfe[name] = BACKWARD_STATS["nfe"]
        for label, a, b in zip(("y0", "w", "t_span"), got, want):
            assert rel(a, b) <= ADJOINT_TOL, (name, label, rel(a, b))
    assert nfe["seminorm"] < nfe["mixed"], nfe

    for ts in (t, np.array([0.0, 1.0])):
        want, got = _adjoint_case(ts, "dopri5", {"max_num_steps": 2})
        assert all(np.isnan(x).all() for x in want + got), ts.size

    w = torch.tensor(W, requires_grad=True)
    with pytest.raises(ValueError, match="adjoint_params"):
        pt.odeint_adjoint(port_field(w), torch.tensor(Y0), torch.tensor(t), "dopri5")
    with pytest.raises(ValueError, match="symplectic"):
        pt.odeint_adjoint(port_field(w), torch.tensor(Y0), torch.tensor(t), "leapfrog",
                          adjoint_params=(w,))


def _spiral_params(np_dtype):
    rng = np.random.RandomState(0)
    return {"w1": (rng.randn(2, 50) * 0.1).astype(np_dtype), "b1": np.zeros(50, np_dtype),
            "w2": (rng.randn(50, 2) * 0.1).astype(np_dtype), "b2": np.zeros(2, np_dtype)}


def test_spiral_float32_matches_jax(capsys):
    """bench.py's spiral neural ODE (``tanh((y**3) @ w1 + b1) @ w2 + b2``,
    y0 = [[2, 0]], dopri5 at rtol 1e-6 / atol 1e-8) over t in [0, 5] at 200
    outputs in float32, the buffered-dense engine of both packages on the
    CPU, within SPIRAL_TOL of the solution's scale; both packages' step
    counts are printed (float32 counts may differ by the libraries'
    rounding). The port's float64 solve is within the same bound."""
    p = _spiral_params(np.float32)
    t = np.linspace(0.0, 5.0, 200, dtype=np.float32)
    y0 = np.array([[2.0, 0.0]], np.float32)
    opts = {"max_steps": 512, "return_stats": True}

    def jvf(t_, y):
        return jnp.tanh((y ** 3) @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]

    want, sj = jax.jit(lambda y: pj.odeint(jvf, y, jnp.asarray(t), "dopri5", rtol=1e-6,
                                           atol=1e-8, time_axis=0, options=opts))(
        jnp.asarray(y0))
    tp = {k: torch.tensor(v) for k, v in p.items()}

    def tvf(t_, y):
        return torch.tanh((y ** 3) @ tp["w1"] + tp["b1"]) @ tp["w2"] + tp["b2"]

    got, st = pt.odeint(tvf, torch.tensor(y0), torch.tensor(t), "dopri5", rtol=1e-6, atol=1e-8,
                        time_axis=0, options=opts)
    tp = {k: torch.tensor(v, dtype=F64) for k, v in p.items()}
    got64, st64 = pt.odeint(tvf, torch.tensor(y0, dtype=F64), torch.tensor(t, dtype=F64),
                            "dopri5", rtol=1e-6, atol=1e-8, time_axis=0, options=opts)
    with capsys.disabled():
        print(f"\nspiral float32 t in [0, 5]: JAX (nfe, accepted, rejected, status) "
              f"{stats_of(sj)}, port {stats_of(st)}; port float64 {stats_of(st64)}")
    assert got.dtype == torch.float32 and got.shape == (200, 1, 2)
    assert st.status == 0 and int(sj.status) == 0
    assert rel(got.numpy(), want) <= SPIRAL_TOL, rel(got.numpy(), want)
    assert rel(got.numpy(), got64.numpy()) <= SPIRAL_TOL, rel(got.numpy(), got64.numpy())


def test_checkpoint_option_and_unported_names():
    """``options={"checkpoint": True}`` gives the fixed solvers' gradients
    unchanged (the JAX package's per-step rematerialisation); the names this
    test once saw refused (the DIRK adaptive solvers, adams, scipy,
    ``odeint_per_element``) now run (their parity with the JAX package:
    ``test_torch_ode_zoo.py``, ``test_torch_ode_events.py``); ``odeint_dense``
    refuses a fixed solver; a typo'd option raises; without a card, numpy
    data makes the entry points raise."""
    t = torch.linspace(0.0, 1.0, 5, dtype=F64)
    grads = []
    for options in ({"step_size": 0.1}, {"step_size": 0.1, "checkpoint": True}):
        y0, w = torch.tensor(Y0, requires_grad=True), torch.tensor(W, requires_grad=True)
        pt.odeint(port_field(w), y0, t, "rk4", options=options).sum().backward()
        grads.append((y0.grad, w.grad))
    for a, b in zip(*grads):
        assert rel(a.numpy(), b.numpy()) <= 1e-14

    f = port_field(torch.tensor(W))
    for name in ("kvaerno3", "sdirk4", "trbdf2", "adams", "scipy_solver"):
        out = pt.odeint(f, torch.tensor(Y0), t, name, rtol=1e-4, atol=1e-6)
        assert out.shape == (2, 5, 3) and torch.isfinite(out).all(), name
    out = pt.functional.odeint_per_element(f, torch.tensor(Y0), t)
    assert out.shape == (2, 5, 3) and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="adaptive"):
        pt.odeint_dense(f, torch.tensor(Y0), t, "rk4")
    with pytest.raises(ValueError, match="unknown solver option"):
        pt.odeint(f, torch.tensor(Y0), t, "dopri5", options={"max_stepz": 3})
    if not torch.cuda.is_available():
        # numpy data goes to the card, and with no card the entry points raise
        for entry in (pt.odeint, pt.odeint_dense, pt.odeint_adjoint):
            with pytest.raises(RuntimeError, match="CUDA"):
                entry(f, Y0, np.linspace(0.0, 1.0, 3), "dopri5")
