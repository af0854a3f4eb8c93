"""The rest of the ODE solver zoo in the port against the JAX package, on the CPU.

The symplectic, Adams, implicit (dense Newton and Newton-Krylov) and SciPy
solvers, the adaptive DIRK solvers, GMRES and the preconditioners, the
gradients through the implicit steps and ``odeint_adjoint`` with a DIRK
solver, the symplecticity pin, ``torch.func.jvp``/``jacfwd`` through a solve
and the CNF divergences. Inputs are made from a numpy seed; the fixed and
the DIRK solvers are one item each. Tolerances (relative to the compared
quantity's scale, float64):

- fixed implicit, symplectic, Adams and SciPy values: 1e-10;
- adaptive DIRK: equal ``nfe``/``n_accept``/``n_reject``, values 1e-9;
- GMRES, the Krylov step and the preconditioners: 1e-8;
- divergences: 1e-12 with the same probes on both sides;
- ``torch.func.jvp``/``jacfwd`` against ``jax.jvp``/``jacfwd``: 1e-9;
- direct gradients through the implicit steps: 1e-9; ``odeint_adjoint``
  with a DIRK solver at rtol 1e-5 against JAX's adjoint: 2e-6 (each
  side's backward is its own adaptive solve of the augmented system, whose
  step control rounds apart: they agree to 4e-7 here, ~rtol/25).

The float64 comparisons use the field of ``test_torch_odeint.py``
(products and sums), which XLA and PyTorch round alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddlexde_tpu as pj
from paddlexde_tpu.solver import implicit as jax_implicit
from paddlexde_tpu.solver import registry as jax_registry
from paddlexde_tpu.solver import symplectic as jax_symplectic
from paddlexde_tpu.utils import divergence as jax_div
from paddlexde_tpu.utils import preconditioners as jax_pre
import paddlexde_tpu_torch as pt
from paddlexde_tpu_torch.solver import implicit as pt_implicit
from paddlexde_tpu_torch.solver import registry as pt_registry
from paddlexde_tpu_torch.solver import symplectic as pt_symplectic
from paddlexde_tpu_torch.utils import divergence as pt_div
from paddlexde_tpu_torch.utils import preconditioners as pt_pre
from paddlexde_tpu_torch.xde.term import ode_term

F64 = torch.float64
VALUE_TOL = 1e-10
DIRK_TOL = 1e-9
KRYLOV_TOL = 1e-8
DIV_TOL = 1e-12
JVP_TOL = 1e-9
GRAD_TOL = 1e-9
ADJOINT_TOL = 2e-6


@pytest.fixture(autouse=True, scope="module")
def _float64_one_thread():
    x64, threads = jax.config.jax_enable_x64, torch.get_num_threads()
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(1)
    yield
    jax.config.update("jax_enable_x64", x64)
    torch.set_num_threads(threads)


RNG = np.random.RandomState(17)
W = RNG.randn(3, 3) * 0.5 - 1.5 * np.eye(3)
Y0 = RNG.randn(2, 3)
T = np.linspace(0.0, 1.0, 6)


def jax_field(w):
    return lambda t, y: (y @ w) * (1.0 + 0.5 * t) - 0.2 * y * y * y


def port_field(w):
    return lambda t, y: (y @ w) * (1.0 + 0.5 * t) - 0.2 * y * y * y


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def test_registry_markers_and_dispatch():
    """Every JAX solver name resolves to the same spec in the port and
    passes ``require_ported``; the JAX registry's public markers exist with
    equal fields; aliases give their solver's bits; a hand-made spec of no
    engine, a marker called as a constructor and a SciPy solve of a tensor
    that requires grad raise."""
    assert set(pt_registry.SOLVERS) == set(jax_registry.SOLVERS) and len(pt_registry.SOLVERS) == 30
    for name, spec in jax_registry.SOLVERS.items():
        got = pt_registry.resolve_solver(name)
        assert (got.name, got.kind, got.order, got.implicit) == (
            spec.name, spec.kind, spec.order, spec.implicit), name
        pt_registry.require_ported(got)
    for marker in jax_registry.__all__:
        if marker in ("SolverSpec", "resolve_solver", "SOLVERS"):
            continue
        a, b = getattr(jax_registry, marker), getattr(pt, marker)
        assert (a.name, a.kind, a.order, a.implicit) == (b.name, b.kind, b.order, b.implicit)
    with pytest.raises(ValueError, match="unknown solver"):
        pt.odeint(port_field(torch.tensor(W)), torch.tensor(Y0), torch.tensor(T),
                  pt.SolverSpec("made_up", "fixed", 1))
    with pytest.raises(TypeError, match="marker"):
        pt.RK4()
    # the other names equal the solver they name (``gauss_legendre1``, which
    # the JAX package's step table lacks, is the implicit midpoint rule)
    tf = port_field(torch.tensor(W))
    for alias, name in ALIASES.items():
        assert torch.equal(pt.odeint(tf, torch.tensor(Y0), torch.tensor(T), alias),
                           pt.odeint(tf, torch.tensor(Y0), torch.tensor(T), name)), alias
    with pytest.raises(TypeError, match="gradients"):
        pt.odeint(tf, torch.tensor(Y0, requires_grad=True), torch.tensor(T), "scipy_solver")
    assert pt_symplectic._W1 == jax_symplectic._W1 and pt_symplectic._W0 == jax_symplectic._W0
    assert pt_implicit._SDIRK2_GAMMA == jax_implicit._SDIRK2_GAMMA
    assert pt_implicit._CROUZEIX_GAMMA == jax_implicit._CROUZEIX_GAMMA


FIXED = ["implicit_euler", "implicit_midpoint", "implicit_euler_krylov", "sdirk2",
         "sdirk2_krylov", "sdirk3", "adams", "implicit_adams", "scipy_solver"]
# names of the same solver as another (equal to it in the port, bit for bit)
ALIASES = {"backward_euler": "implicit_euler", "gauss_legendre1": "implicit_midpoint",
           "explicit_adams": "adams", "adams_bashforth_moulton": "adams"}


def _jax_odeint(name, t, **kw):
    """The JAX package's float64 solve of ``jax_field(W)`` from Y0, jitted
    (SciPy calls the field eagerly on the host: not jitted)."""
    if name == "scipy_solver":
        with jax.disable_jit():
            return pj.odeint(jax_field(W), jnp.asarray(Y0), jnp.asarray(t), name, time_axis=0,
                             **kw)
    return jax.jit(lambda y: pj.odeint(jax_field(W), y, jnp.asarray(t), name, time_axis=0,
                                       **kw))(jnp.asarray(Y0))


@pytest.mark.parametrize("name", FIXED)
def test_fixed_implicit_adams_and_scipy_against_jax(name):
    """float64 values of each fixed implicit, Adams and SciPy solver on a
    uniform grid (Adams: 20 steps, so the order climbs past the bootstrap)
    within VALUE_TOL; sdirk2 also backwards in time, implicit Adams also
    with ``step_size``, ``max_order`` and ``max_iters``."""
    tf = port_field(torch.tensor(W))
    t = np.linspace(0.0, 1.0, 21) if "adams" in name else T
    got = pt.odeint(tf, torch.tensor(Y0), torch.tensor(t), name, time_axis=0)
    assert rel(got.numpy(), _jax_odeint(name, t)) <= VALUE_TOL, name
    if name == "sdirk2":  # backwards over a short span (there the cubic term grows)
        t = np.linspace(0.0, 0.2, 3)[::-1].copy()
        got = pt.odeint(tf, torch.tensor(Y0), torch.tensor(t), name, time_axis=0)
        assert rel(got.numpy(), _jax_odeint(name, t)) <= VALUE_TOL
    if name == "implicit_adams":
        opts = {"step_size": 0.05, "max_order": 6, "max_iters": 3}
        want = pj.odeint(jax_field(W), jnp.asarray(Y0), jnp.asarray(T), name, options=opts)
        got = pt.odeint(tf, torch.tensor(Y0), torch.tensor(T), name, options=opts)
        assert rel(got.numpy(), want) <= VALUE_TOL


def test_symplectic_solvers_and_symplecticity_pin():
    """leapfrog, velocity_verlet and yoshida4 on the pendulum's (q, p)
    pair against JAX within VALUE_TOL; the symplecticity pin: det of one
    step's phase-space Jacobian is 1 to rounding for yoshida4 and leapfrog,
    and not for rk4, the control; over 2000 steps yoshida4's energy error
    stays bounded where rk4's drifts."""
    jh = lambda t, y: (y[1], -jnp.sin(y[0]))  # noqa: E731
    th = lambda t, y: (y[1], -torch.sin(y[0]))  # noqa: E731
    q0, p0 = np.array([1.5, 0.3]), np.array([0.0, 0.4])
    t = np.linspace(0.0, 3.0, 16)
    for name in ("leapfrog", "velocity_verlet", "yoshida4"):
        want = jax.jit(lambda y, name=name: pj.odeint(jh, y, jnp.asarray(t), name, time_axis=0))(
            (jnp.asarray(q0), jnp.asarray(p0)))
        got = pt.odeint(th, (torch.tensor(q0), torch.tensor(p0)), torch.tensor(t), name,
                        time_axis=0)
        for g, w in zip(got, want):
            assert rel(g.numpy(), w) <= VALUE_TOL, name

    term = ode_term(th)
    steps = {"yoshida4": pt_symplectic.yoshida4_step, "leapfrog": pt_symplectic.leapfrog_step,
             "rk4": pt.solver.fixed.rk4_step}
    dets = {}
    for name, step in steps.items():
        def flow(z, step=step):
            y1, _ = step(term, torch.tensor(0.0, dtype=F64), torch.tensor(0.3, dtype=F64),
                         (z[:1], z[1:]))
            return torch.cat(y1)

        jac = torch.autograd.functional.jacobian(flow, torch.tensor([1.5, 0.2], dtype=F64))
        dets[name] = float(torch.linalg.det(jac))
    assert abs(dets["yoshida4"] - 1.0) < 1e-13 and abs(dets["leapfrog"] - 1.0) < 1e-13, dets
    assert abs(dets["rk4"] - 1.0) > 1e-9, dets  # O(h^5) = 2.6e-7 here

    def energy_drift(name):
        ts = torch.linspace(0.0, 500.0, 2001, dtype=F64)
        q, p = pt.odeint(th, (torch.tensor([1.5], dtype=F64), torch.tensor([0.0], dtype=F64)),
                         ts, name, time_axis=0)
        h = 0.5 * p**2 + (1.0 - torch.cos(q))
        return (h - h[0]).abs().max().item(), (h[-1] - h[0]).abs().item()

    y_max, _ = energy_drift("yoshida4")
    rk_max, rk_end = energy_drift("rk4")
    assert y_max < 1e-3 and rk_end > 10 * y_max, (y_max, rk_max, rk_end)


DIRK = [("kvaerno3", 1e-5), ("sdirk4", 1e-5), ("trbdf2", 1e-5)]


@pytest.mark.parametrize("name,rtol", DIRK)
def test_adaptive_dirk_against_jax(name, rtol):
    """kvaerno3 through the per-output engine, trbdf2 with ``newton_iters``
    4, and sdirk4 (the implicit first stage) through the buffered-dense
    engine, ``odeint_dense`` and the per-output engine: ``nfe``,
    ``n_accept`` and ``n_reject`` equal to the JAX engine's, values within
    DIRK_TOL."""
    jf, tf = jax_field(W), port_field(torch.tensor(W))
    opts = {"newton_iters": 4} if name == "trbdf2" else (
        {"max_steps": 128} if name == "sdirk4" else {})
    jopts = dict(opts, return_stats=True)
    if "max_steps" not in opts:
        jopts["direct_grad"] = False
    want, ws = jax.jit(lambda y: pj.odeint(jf, y, jnp.asarray(T), name, rtol=rtol, atol=1e-9,
                                           options=jopts, time_axis=0))(jnp.asarray(Y0))
    got, gs = pt.odeint(tf, torch.tensor(Y0), torch.tensor(T), name, rtol=rtol, atol=1e-9,
                        options=dict(opts, return_stats=True), time_axis=0)
    assert tuple(gs) == tuple(int(x) for x in ws), (name, opts, tuple(gs), ws)
    assert gs.status == 0 and rel(got.numpy(), want) <= DIRK_TOL, (name, opts)
    if name == "sdirk4":
        dense = pt.odeint_dense(tf, torch.tensor(Y0), torch.tensor(T), name, rtol=rtol,
                                atol=1e-9, options=dict(opts))
        assert rel(dense(torch.tensor(T)).numpy(), want) <= DIRK_TOL
        # the per-output engine takes the same steps
        per_output, ps = pt.odeint(tf, torch.tensor(Y0), torch.tensor(T), name, rtol=rtol,
                                   atol=1e-9, options={"return_stats": True}, time_axis=0)
        assert tuple(ps) == tuple(gs) and rel(per_output.numpy(), want) <= DIRK_TOL


def test_gmres_and_preconditioners_against_jax():
    """GMRES against ``jax.scipy.sparse.linalg.gmres(solve_method="batched")``
    (restarted, converged early, preconditioned, restart above the size) and
    its gradient against ``jax.grad``; dst1 and the Dirichlet, periodic and
    Neumann heat preconditioners (the last also against the exact inverse:
    the JAX package rounds it through complex64); the Jacobi preconditioner
    exact and with the same probes; a preconditioned Newton-Krylov step on a
    Fisher-KPP grid -- all within KRYLOV_TOL."""
    from jax.scipy.sparse.linalg import gmres as jgmres

    rng = np.random.RandomState(3)
    for n, restart, maxiter, pre in [(12, 5, 3, False), (12, 20, 4, False), (30, 6, 2, True),
                                     (8, 40, 2, False)]:
        a = np.eye(n) * 3 + rng.randn(n, n) * 0.5
        b, c = rng.randn(n), rng.randn(n)
        m = np.diag(1.0 / np.diag(a)) if pre else None

        def value(aj, bj, m=m, restart=restart, maxiter=maxiter, c=c):
            x = jgmres(lambda v: aj @ v, bj, tol=1e-8, atol=0.0, restart=restart,
                       maxiter=maxiter, solve_method="batched",
                       M=None if m is None else (lambda v: jnp.asarray(m) @ v))[0]
            return jnp.dot(jnp.asarray(c), x), x

        (_, want), (ga, gb) = jax.jit(jax.value_and_grad(value, argnums=(0, 1), has_aux=True))(
            jnp.asarray(a), jnp.asarray(b))
        at, bt = torch.tensor(a, requires_grad=True), torch.tensor(b, requires_grad=True)
        mt = None if m is None else torch.tensor(m)
        got, info = pt.solver.gmres(lambda v: at @ v, bt, tol=1e-8, restart=restart,
                                   maxiter=maxiter, M=None if mt is None else (lambda v: mt @ v))
        (got @ torch.tensor(c)).backward()
        assert int(info) == 0 and rel(got.detach().numpy(), want) <= KRYLOV_TOL, n
        assert rel(at.grad.numpy(), ga) <= KRYLOV_TOL and rel(bt.grad.numpy(), gb) <= KRYLOV_TOL

    v = rng.randn(3, 31)
    assert rel(pt_pre.dst1(torch.tensor(v)).numpy(), jax_pre.dst1(jnp.asarray(v))) <= KRYLOV_TOL
    for kind, n in (("dirichlet", 31), ("periodic", 32)):
        jm = getattr(jax_pre, f"{kind}_heat_preconditioner")(n, 1.0 / (n + 1), 0.1, nu=0.3)
        tm = getattr(pt_pre, f"{kind}_heat_preconditioner")(n, 1.0 / (n + 1), 0.1, nu=0.3)
        vv = rng.randn(n)
        assert rel(tm(torch.tensor(vv)).numpy(), jm(jnp.asarray(vv))) <= KRYLOV_TOL, kind
    n, dx, nu, dt = 32, 1.0 / 32, 0.3, 0.1
    vv = rng.randn(n)
    lap = (np.diag(-2.0 * np.ones(n)) + np.diag(np.ones(n - 1), 1) + np.diag(np.ones(n - 1), -1))
    lap[0, 0] = lap[-1, -1] = -1.0  # the ghost points u[-1] = u[0], u[n] = u[n-1]
    exact = np.linalg.solve(np.eye(n) - nu * dt * lap / dx**2, vv)
    got = pt_pre.neumann_heat_preconditioner(n, dx, dt, nu=nu)(torch.tensor(vv)).numpy()
    assert rel(got, exact) <= 1e-12
    assert rel(got, jax_pre.neumann_heat_preconditioner(n, dx, dt, nu=nu)(jnp.asarray(vv))) <= 1e-6

    a = np.eye(6) * 4 + rng.randn(6, 6) * 0.3
    ja = lambda x: jnp.asarray(a) @ x  # noqa: E731
    ta = lambda x: torch.tensor(a) @ x  # noqa: E731
    vv = rng.randn(6)
    jm = jax_pre.jacobi_preconditioner(ja, jnp.zeros(6))
    tm = pt_pre.jacobi_preconditioner(ta, torch.zeros(6, dtype=F64))
    assert rel(tm(torch.tensor(vv)).numpy(), jm(jnp.asarray(vv))) <= KRYLOV_TOL
    key = jax.random.key(5)
    probes = jax.random.rademacher(key, (3, 6), dtype=jnp.float64)
    jm = jax_pre.jacobi_preconditioner(ja, jnp.zeros(6), probes=3, key=key)
    tm = pt_pre.jacobi_preconditioner(ta, torch.zeros(6, dtype=F64),
                                      probes=torch.tensor(np.asarray(probes)))
    assert rel(tm(torch.tensor(vv)).numpy(), jm(jnp.asarray(vv))) <= KRYLOV_TOL
    gen = torch.Generator().manual_seed(0)
    drawn = pt_pre.jacobi_preconditioner(ta, torch.zeros(6, dtype=F64), probes=4, generator=gen)
    assert torch.isfinite(drawn(torch.tensor(vv))).all()

    # Fisher-KPP on 31 points, the demo's preconditioned Krylov step
    d = 31
    dx = 1.0 / (d + 1)
    x = np.arange(1, d + 1) * dx
    u0 = np.exp(-200.0 * (x - 0.2) ** 2)
    t = np.linspace(0.0, 2.0, 3)

    def jkpp(t, u):
        up = jnp.pad(u, 1)
        return 1e-3 * (up[2:] - 2.0 * up[1:-1] + up[:-2]) / dx**2 + u * (1.0 - u)

    def tkpp(t, u):
        up = torch.nn.functional.pad(u, (1, 1))
        return 1e-3 * (up[2:] - 2.0 * up[1:-1] + up[:-2]) / dx**2 + u * (1.0 - u)

    kw = {"newton_iters": 3, "gmres_restart": 10, "gmres_maxiter": 2}
    jstep = jax_implicit.make_implicit_euler_krylov_step(
        preconditioner=jax_pre.dirichlet_heat_preconditioner(d, dx, 1.0, nu=1e-3), **kw)
    tstep = pt_implicit.make_implicit_euler_krylov_step(
        preconditioner=pt_pre.dirichlet_heat_preconditioner(d, dx, 1.0, nu=1e-3), **kw)
    want = jax.jit(lambda u: pj.odeint(jkpp, u, jnp.asarray(t), jstep, time_axis=0))(
        jnp.asarray(u0))
    got = pt.odeint(tkpp, torch.tensor(u0), torch.tensor(t), tstep, time_axis=0)
    assert rel(got.numpy(), want) <= KRYLOV_TOL


def test_gradients_through_implicit_steps_and_dirk_adjoint():
    """Direct gradients (to the field's weights and y0) through
    implicit_euler_krylov (the transposed GMRES solve) and kvaerno3 (dense
    Newton in the DIRK stages) against ``jax.grad`` within GRAD_TOL;
    ``odeint_adjoint`` with sdirk4 as forward and adjoint solver against
    JAX's ``odeint_adjoint`` within ADJOINT_TOL."""
    t = np.linspace(0.0, 0.5, 3)

    def loss_j(fn, name, w0, y0, **kw):
        def loss(w, y):
            out = fn(jax_field(w), y, jnp.asarray(t), name, time_axis=0, **kw)
            return jnp.sum(out[-1] ** 2) + jnp.sum(out[1])

        return jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(w0), jnp.asarray(y0))

    def loss_t(fn, name, w0, y0, **kw):
        w = torch.tensor(w0, requires_grad=True)
        y = torch.tensor(y0, requires_grad=True)
        if fn is pt.odeint_adjoint:
            kw["adjoint_params"] = (w,)
        out = fn(port_field(w), y, torch.tensor(t), name, time_axis=0, **kw)
        ((out[-1] ** 2).sum() + out[1].sum()).backward()
        return w.grad.numpy(), y.grad.numpy()

    w2, y2 = W[:2, :2], Y0[0, :2]
    for name, w0, y0, kw in (("implicit_euler_krylov", W, Y0, {}),
                             ("kvaerno3", w2, y2, {"rtol": 1e-4, "atol": 1e-8})):
        for g, w in zip(loss_t(pt.odeint, name, w0, y0, **kw),
                        loss_j(pj.odeint, name, w0, y0, **kw)):
            assert rel(g, w) <= GRAD_TOL, (name, rel(g, w))
    kw = {"rtol": 1e-5, "atol": 1e-8}
    for g, w in zip(loss_t(pt.odeint_adjoint, "sdirk4", w2, y2, **kw),
                    loss_j(pj.odeint_adjoint, "sdirk4", w2, y2, **kw)):
        assert rel(g, w) <= ADJOINT_TOL, rel(g, w)


def test_forward_mode_transforms_through_a_solve():
    """``torch.func.jacfwd`` of ``odeint`` through dopri5 (the grid frozen,
    as in the JAX package) and rk4 with ``step_size`` against
    ``jax.jacfwd`` within JVP_TOL, and ``torch.func.jvp`` against the same
    JAX derivative applied to the tangent (``jax.jvp`` is ``J v``; one JAX
    compilation serves both)."""
    y0, v = Y0[0], np.array([0.3, -1.0, 0.5])
    jf, tf = jax_field(W), port_field(torch.tensor(W))
    for name, opts in (("dopri5", None), ("rk4", {"step_size": 0.25})):
        def jsolve(y, name=name, opts=opts):
            return pj.odeint(jf, y, jnp.asarray(T), name, rtol=1e-6, options=opts, time_axis=0)

        def tsolve(y, name=name, opts=opts):
            return pt.odeint(tf, y, torch.tensor(T), name, rtol=1e-6, options=opts, time_axis=0)

        want_y = jsolve(jnp.asarray(y0))
        jac_fn = jax.jacfwd(jsolve)  # step_size needs concrete times: no jit there
        want_j = np.asarray((jac_fn if opts else jax.jit(jac_fn))(jnp.asarray(y0)))
        gp, gt = torch.func.jvp(tsolve, (torch.tensor(y0),), (torch.tensor(v),))
        assert rel(gp.numpy(), want_y) <= JVP_TOL and rel(gt.numpy(), want_j @ v) <= JVP_TOL, name
        jac = torch.func.jacfwd(tsolve)(torch.tensor(y0))
        assert rel(jac.numpy(), want_j) <= JVP_TOL, name


def test_cnf_divergences_against_jax():
    """exact_divergence, hutchinson_divergence (the same Rademacher probes
    on both sides) and both forms of cnf_aug_dynamics, within DIV_TOL."""
    rng = np.random.RandomState(9)
    w1, w2 = rng.randn(2, 8) * 0.5, rng.randn(8, 2) * 0.5

    def jfield(t, y):
        return jnp.tanh(y @ w1 + t) @ w2

    def tfield(t, y):
        return torch.tanh(y @ torch.tensor(w1) + t) @ torch.tensor(w2)

    y = rng.randn(5, 2)
    t = 0.3
    jfd, jdiv = jax.jit(jax_div.exact_divergence(jfield))(t, jnp.asarray(y[0]))
    tfd, tdiv = pt_div.exact_divergence(tfield)(torch.tensor(t, dtype=F64), torch.tensor(y[0]))
    assert rel(tfd.numpy(), jfd) <= DIV_TOL and rel(tdiv.numpy(), jdiv) <= DIV_TOL
    key = jax.random.key(2)
    eps = np.asarray(jax.random.rademacher(key, (3, 2), dtype=jnp.float64))
    _, jh = jax.jit(jax_div.hutchinson_divergence(jfield, 3))(t, jnp.asarray(y[0]), key)
    _, th = pt_div.hutchinson_divergence(tfield, 3)(torch.tensor(t, dtype=F64),
                                                    torch.tensor(y[0]), torch.tensor(eps))
    assert rel(th.numpy(), jh) <= DIV_TOL
    state_j, state_t = (jnp.asarray(y), jnp.zeros(5)), (torch.tensor(y), torch.zeros(5, dtype=F64))
    jout = jax.jit(jax_div.cnf_aug_dynamics(jfield, "exact"))(t, state_j)
    tout = pt_div.cnf_aug_dynamics(tfield, "exact")(torch.tensor(t, dtype=F64), state_t)
    for g, w in zip(tout, jout):
        assert rel(g.numpy(), w) <= DIV_TOL
    keys = jax.random.split(jax.random.key(4), 5)
    probes = np.stack([np.asarray(jax.random.rademacher(k, (2, 2), dtype=jnp.float64))
                       for k in keys])
    jout = jax.jit(lambda k, s_: jax_div.cnf_aug_dynamics(jfield, "hutchinson", probes=2)(k)(
        t, s_))(keys, state_j)
    tout = pt_div.cnf_aug_dynamics(tfield, "hutchinson", probes=2)(torch.tensor(probes))(
        torch.tensor(t, dtype=F64), state_t)
    for g, w in zip(tout, jout):
        assert rel(g.numpy(), w) <= DIV_TOL
    gen = torch.Generator().manual_seed(1)
    drawn = pt_div.rademacher_probes((4, 3), generator=gen, dtype=F64)
    assert set(drawn.unique().tolist()) <= {-1.0, 1.0}
    # a CNF solve of the exact form: log-density change stays finite
    ys, lp = pt.odeint(pt_div.cnf_aug_dynamics(tfield, "exact"), state_t,
                       torch.linspace(0.0, 1.0, 3, dtype=F64), "rk4", time_axis=0,
                       options={"step_size": 0.25})
    assert ys.shape == (3, 5, 2) and lp.shape == (3, 5) and torch.isfinite(lp).all()
    with pytest.raises(ValueError, match="divergence"):
        pt_div.cnf_aug_dynamics(tfield, "trace")


def test_profiling_and_version(tmp_path):
    """The profiling helpers and the version module: a CPU trace is
    written, the meter averages, the version names torch."""
    from paddlexde_tpu_torch.utils import profiling
    from paddlexde_tpu_torch import version

    with profiling.trace(str(tmp_path)) as prof:
        torch.ones(3).sum()
    assert (tmp_path / "trace.json").is_file() and prof is not None
    meter = profiling.RunningAverageMeter(0.5)
    meter.update(1.0)
    meter.update(3.0)
    assert meter.avg == 2.0 and meter.val == 3.0
    timer = profiling.Timer()
    assert timer.elapsed() >= 0.0
    assert pt.__version__ == version.__version__ and "torch" in version.show()
