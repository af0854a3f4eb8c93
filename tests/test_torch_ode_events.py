"""Events and per-element step control in the port against the JAX package, on the CPU.

``odeint_event`` (the event time within 1e-10, the state, the flags, and
one host read per attempted step: the sign test rides in the engine's
read), ``odeint_event_grad`` (the event time's gradient against JAX's and
the closed forms, within 1e-7: JAX differentiates the state at the event by
its adjoint, the port by autograd through its solve, both at rtol 1e-9),
and ``odeint_per_element`` (per-element ``nfe``, ``n_accept``, ``n_reject``
and status equal to ``jax.vmap`` over the JAX ``odeint``, values within
1e-10, one host read per controller step). Inputs from a numpy seed; float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddlexde_tpu as pj
import paddlexde_tpu_torch as pt
from paddlexde_tpu_torch.solver import adaptive as pt_adaptive

F64 = torch.float64
EVENT_TOL = 1e-10
EVENT_GRAD_TOL = 1e-7
VALUE_TOL = 1e-10
G = 9.81


@pytest.fixture(autouse=True, scope="module")
def _float64_one_thread():
    x64, threads = jax.config.jax_enable_x64, torch.get_num_threads()
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(1)
    yield
    jax.config.update("jax_enable_x64", x64)
    torch.set_num_threads(threads)


def test_odeint_event_against_jax():
    """The bouncing ball of the JAX package's demo (dopri5; impact at
    sqrt(2 h0 / g)) and a threshold on a decaying 3-state system (bosh3, a
    tensor t0): the event time within EVENT_TOL of JAX's, the state at the
    event, ``event_fired`` and ``status``; the loop reads the card once per
    attempted step plus the initial sign; a horizon before the event leaves
    it unfired at ``t_max``; a fixed-grid solver raises."""
    jball = lambda t, y: jnp.stack([y[1], -G * jnp.ones_like(y[0])])  # noqa: E731
    tball = lambda t, y: torch.stack([y[1], -G * torch.ones_like(y[0])])  # noqa: E731
    ground = lambda t, y: y[0]  # noqa: E731
    want = jax.jit(lambda y: pj.odeint_event(jball, y, 0.0, ground, "dopri5", t_max=10.0))(
        jnp.asarray([10.0, 0.0]))
    pt_adaptive.reset_host_reads()
    got = pt.odeint_event(tball, torch.tensor([10.0, 0.0], dtype=F64), 0.0, ground, "dopri5",
                          t_max=10.0)
    reads = dict(pt_adaptive.HOST_READS)
    assert abs(float(got.t_event) - float(want.t_event)) <= EVENT_TOL
    assert abs(float(got.t_event) - np.sqrt(2 * 10.0 / G)) <= 1e-9
    assert np.abs(got.y_event.numpy() - np.asarray(want.y_event)).max() <= 1e-9
    assert got.event_fired and bool(want.event_fired) and got.status == int(want.status) == 0
    assert reads["setup"] == 1 and reads["step"] >= 1

    rng = np.random.RandomState(5)
    a = -np.eye(3) * np.array([1.0, 2.0, 3.0]) + rng.randn(3, 3) * 0.1
    y0 = np.array([1.0, 0.5, -0.2])
    jf = lambda t, y: y @ a - 0.1 * y * y * y  # noqa: E731
    tf = lambda t, y: y @ torch.tensor(a) - 0.1 * y * y * y  # noqa: E731
    thresh = lambda t, y: y[0] - 0.3  # noqa: E731
    for t_max in (None, 0.2):
        want = jax.jit(lambda y, t_max=t_max: pj.odeint_event(
            jf, y, jnp.asarray(0.0), thresh, "bosh3", t_max=t_max, rtol=1e-8, atol=1e-10))(
            jnp.asarray(y0))
        pt_adaptive.reset_host_reads()
        got = pt.odeint_event(tf, torch.tensor(y0), torch.tensor(0.0, dtype=F64), thresh, "bosh3",
                              t_max=t_max, rtol=1e-8, atol=1e-10)
        assert abs(float(got.t_event) - float(want.t_event)) <= EVENT_TOL, t_max
        assert np.abs(got.y_event.numpy() - np.asarray(want.y_event)).max() <= 1e-9
        assert got.event_fired == bool(want.event_fired) == (t_max is None)
        assert got.status == int(want.status)
        assert pt_adaptive.HOST_READS["setup"] == 1
    with pytest.raises(ValueError, match="adaptive"):
        pt.odeint_event(tf, torch.tensor(y0), 0.0, thresh, "rk4")


def test_odeint_event_grad_against_jax():
    """dt*/dh0 of the ball's impact (closed form 1 / sqrt(2 g h0)) and the
    gradients of the threshold time of ``y' = -k y`` to ``k`` (a tensor the
    field closes over) and to ``y0`` (closed forms ``-t*/k``, ``1/(k y0)``),
    each against ``jax.grad`` of the JAX ``odeint_event_grad`` within
    EVENT_GRAD_TOL; the event state's gradient, zero there (the state sits
    on the threshold)."""
    jball = lambda t, y: jnp.stack([y[1], -G * jnp.ones_like(y[0])])  # noqa: E731
    tball = lambda t, y: torch.stack([y[1], -G * torch.ones_like(y[0])])  # noqa: E731
    ground = lambda t, y: y[0]  # noqa: E731
    want = jax.jit(jax.grad(lambda h: pj.odeint_event_grad(
        jball, jnp.stack([h, jnp.zeros(())]), 0.0, ground, "dopri5", t_max=10.0).t_event))(
        jnp.asarray(10.0))
    h = torch.tensor(10.0, dtype=F64, requires_grad=True)
    res = pt.odeint_event_grad(tball, torch.stack([h, torch.zeros((), dtype=F64)]), 0.0, ground,
                               "dopri5", t_max=10.0)
    res.t_event.backward()
    assert abs(float(h.grad) - float(want)) <= EVENT_GRAD_TOL * abs(float(want))
    assert abs(float(h.grad) - 1.0 / np.sqrt(2 * G * 10.0)) <= 1e-6

    k0, y00 = 1.3, 1.0
    want = jax.jit(jax.grad(lambda k, y: pj.odeint_event_grad(
        lambda t, z: -k * z, jnp.stack([y]), 0.0, lambda t, z: z[0] - 0.25, "dopri5",
        t_max=10.0).t_event, argnums=(0, 1)))(jnp.asarray(k0), jnp.asarray(y00))
    for which in ("t_event", "y_event"):
        k = torch.tensor(k0, dtype=F64, requires_grad=True)
        y0 = torch.tensor(y00, dtype=F64, requires_grad=True)
        r = pt.odeint_event_grad(lambda t, y: -k * y, torch.stack([y0]), 0.0,
                                 lambda t, y: y[0] - 0.25, "dopri5", t_max=10.0)
        (r.t_event if which == "t_event" else r.y_event[0]).backward()
        if which == "t_event":
            for g, w in zip((k.grad, y0.grad), want):
                assert abs(float(g) - float(w)) <= EVENT_GRAD_TOL * abs(float(w))
            t_star = np.log(4.0) / k0
            assert abs(float(k.grad) + t_star / k0) <= 1e-6 and abs(float(y0.grad) - 1 / k0) <= 1e-6
        else:  # the event state sits on the threshold whatever k and y0
            assert abs(float(k.grad)) <= 1e-8 and abs(float(y0.grad)) <= 1e-8


def test_odeint_per_element_against_jax_vmap():
    """Six elements of a relaxation ``y' = -lam (y - cos t)`` with a
    stiffness spread of 1..160 (the rate rides in the state, as in the JAX
    package's measurement): per-element ``nfe``, ``n_accept``, ``n_reject``
    and status equal to ``jax.vmap`` over the JAX ``odeint`` (dopri5 and
    tsit5, rtol 1e-5), values within VALUE_TOL, the spread of ``nfe``
    visible, one host read per controller step; a decreasing span; rk4 on
    the shared grid (the batched solve, bit for bit); the implicit solvers and a field that reads the host
    are refused with a message that names ``odeint``."""
    batch = 6
    y0 = np.stack([np.ones(batch), np.linspace(1.0, 160.0, batch)], 1)

    def fields(sign):  # sign -1 relaxes forwards in time, +1 backwards
        return (lambda t, y: jnp.stack([sign * y[1] * (y[0] - jnp.cos(t)), jnp.zeros_like(y[1])]),
                lambda t, y: torch.stack([sign * y[1] * (y[0] - torch.cos(t)),
                                          torch.zeros_like(y[1])]))

    jf, tf = fields(-1.0)
    for name, t, sign in (("dopri5", np.linspace(0.0, 1.0, 5), -1.0),
                          ("tsit5", np.linspace(1.0, 0.0, 4), 1.0)):
        jfs, tfs = fields(sign)
        want, ws = jax.jit(lambda y, t, jfs=jfs, name=name: pj.odeint_per_element(
            jfs, y, t, name, rtol=1e-5, atol=1e-8, options={"return_stats": True}))(
            jnp.asarray(y0), jnp.asarray(t))
        pt_adaptive.reset_host_reads()
        got, gs = pt.odeint_per_element(tfs, torch.tensor(y0), torch.tensor(t), name, rtol=1e-5,
                                        atol=1e-8, options={"return_stats": True})
        for g, w in zip(gs, ws):
            assert g.tolist() == np.asarray(w).tolist(), (name, gs, ws)
        assert got.shape == want.shape
        assert np.abs(got.numpy() - np.asarray(want)).max() <= VALUE_TOL, name
        assert len(set(gs.nfe.tolist())) == batch
        # one read a controller step, in which every element still short of
        # the current output attempts a step: at least an element's most
        # attempts, at most their sum
        attempts = gs.n_accept + gs.n_reject
        reads = pt_adaptive.HOST_READS["step"]
        assert int(attempts.max()) <= reads <= int(attempts.sum()), (reads, attempts)
    # a fixed-grid solver: the batched solve on the shared grid, batch first
    t = np.linspace(0.0, 1.0, 5)
    got = pt.odeint_per_element(tf, torch.tensor(y0[:2]), torch.tensor(t), "rk4",
                                options={"step_size": 0.01})
    want = pt.odeint(lambda t, y: torch.stack([tf(t, e) for e in y]), torch.tensor(y0[:2]),
                     torch.tensor(t), "rk4", options={"step_size": 0.01}, time_axis=0)
    assert torch.equal(got, want.transpose(0, 1))
    with pytest.raises(ValueError, match="use odeint"):
        pt.odeint_per_element(tf, torch.tensor(y0), torch.tensor(t), "kvaerno3")

    def host_reader(t, y):
        return -y * float(y[0])

    with pytest.raises(ValueError, match="Use odeint"):
        pt.odeint_per_element(host_reader, torch.tensor(y0), torch.tensor(t), "dopri5")
