"""The port's sdeint against the JAX package's, pathwise, on the CPU.

Each ported scheme (euler, milstein, sra1, sra1_general, sriw1,
heun_stratonovich, foster2, foster2_general, euler_general,
milstein_general, milstein_commutative) solves one small problem with the
same key on both sides, forward and with ``reverse=True``, in float64:
the paths agree within PATH_TOL (measured ~1e-14: the Brownian tree's
sums associate apart, the schemes' arithmetic is the JAX form's). The JAX
side compiles each scheme's forward and reverse solve once, together.

Also: the registry table equals the JAX one field by field; every name
that is not ported, and ``adaptive=True``, raises ``NotImplementedError``
naming ROADMAP item 8; the validation errors (a missing Lévy mode, a 1-D
bm for a general scheme, an ODE solver name) are the JAX package's; the
Itô/Stratonovich conversions agree with JAX's within 1e-12.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddlexde_tpu as pj
from paddlexde_tpu.functional.sde_schemes import registry as jax_registry
import paddlexde_tpu_torch as pt
from paddlexde_tpu_torch.functional.sde_schemes import registry as pt_registry

F64 = torch.float64
PATH_TOL = 1e-11
CONVERSION_TOL = 1e-12

_RNG = np.random.default_rng(0)
_Y0 = _RNG.uniform(0.5, 1.5, (3, 2))
_A = _RNG.normal(size=(2, 2)) * 0.3
_L = _RNG.normal(size=(2, 2)) * 0.3
_T = np.linspace(0.0, 1.0, 9)


@pytest.fixture(autouse=True, scope="module")
def _float64_one_thread():
    x64, threads = jax.config.jax_enable_x64, torch.get_num_threads()
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(1)
    yield
    jax.config.update("jax_enable_x64", x64)
    torch.set_num_threads(threads)


# the problem in both packages: a nonlinear drift, and a multiplicative
# diagonal, additive diagonal, multiplicative matrix and additive matrix
# diffusion (time-dependent where the additive schemes need g(t))
def _fields(np_like, tensor):
    A, L = tensor(_A), tensor(_L)

    def drift(t, y):
        return np_like.tanh(y @ A) * 0.5 + 0.1 * t

    def diag(t, y):
        return 0.2 * np_like.sin(y) + 0.3

    def diag_additive(t, y):
        return 0.3 * (1 + t) + 0.0 * y

    def matrix(t, y):
        return 0.2 * np_like.sin(y)[..., :, None] * L + 0.1

    def matrix_additive(t, y):
        return L * (1 + t) + 0.0 * y[..., :, None]

    return drift, {"diag": diag, "diag_additive": diag_additive, "matrix": matrix,
                   "matrix_additive": matrix_additive}


_SCHEMES = [
    ("euler", "diag", {}),
    ("milstein", "diag", {}),
    ("sra1", "diag_additive", {}),
    ("sriw1", "diag", {}),
    ("heun_stratonovich", "diag", {}),
    ("foster2", "diag_additive", {}),
    ("euler_general", "matrix", {"noise_dim": 2}),
    ("milstein_general", "matrix", {"noise_dim": 2, "levy_area_approximation": "foster"}),
    ("milstein_commutative", "matrix", {"noise_dim": 2}),
    ("sra1_general", "matrix_additive", {"noise_dim": 2}),
    ("foster2_general", "matrix_additive", {"noise_dim": 2}),
]


def _check_every_ported_scheme_pathwise():
    j_drift, j_g = _fields(jnp, jnp.asarray)
    p_drift, p_g = _fields(torch, torch.tensor)
    errors = {}
    for name, noise, kw in _SCHEMES:
        def jax_solves(y0, t, name=name, noise=noise, kw=kw):
            return tuple(pj.sdeint(j_drift, j_g[noise], y0, t, name, key=7, reverse=rev,
                                   time_axis=0, **kw) for rev in (False, True))

        want = jax.jit(jax_solves)(jnp.asarray(_Y0), jnp.asarray(_T))
        for rev, w in zip((False, True), want):
            got = pt.sdeint(p_drift, p_g[noise], torch.tensor(_Y0), torch.tensor(_T), name,
                            key=7, reverse=rev, time_axis=0, **kw)
            errors[name, rev] = float(np.max(np.abs(np.asarray(w) - got.numpy())))
    assert max(errors.values()) <= PATH_TOL, errors
    # an explicit bm shared by the space-time schemes; an alias
    pbm = pt.BrownianInterval(0.0, 1.0, size=(3, 2), dtype=F64, key=11,
                              levy_area_approximation="space-time", device="cpu")
    jbm = pj.BrownianInterval(0.0, 1.0, size=(3, 2), dtype=jnp.float64, key=11,
                              levy_area_approximation="space-time")
    for name in ("sriw1", "SRA1", "stratonovich_heun"):
        want = pj.sdeint(j_drift, j_g["diag"], jnp.asarray(_Y0), jnp.asarray(_T[:4]), name,
                         bm=jbm, time_axis=0)
        got = pt.sdeint(p_drift, p_g["diag"], torch.tensor(_Y0), torch.tensor(_T[:4]), name,
                        bm=pbm, time_axis=0)
        assert np.max(np.abs(np.asarray(want) - got.numpy())) <= PATH_TOL, name


def _check_registry_refusals_validation_and_conversions():
    # the table, field by field (the factories aside)
    assert set(pt_registry.SDE_SCHEMES) == set(jax_registry.SDE_SCHEMES)
    for name, spec in jax_registry.SDE_SCHEMES.items():
        mine = pt_registry.SDE_SCHEMES[name]
        for field in dataclasses.fields(spec):
            if field.name != "factory":
                assert getattr(mine, field.name) == getattr(spec, field.name), (name, field.name)
    assert pt_registry.PORTED == {s for s, _, _ in _SCHEMES}

    p_drift, p_g = _fields(torch, torch.tensor)
    y0, t = torch.tensor(_Y0), torch.tensor(_T[:3])
    for name in sorted(set(pt_registry.SDE_SCHEMES)):
        if pt_registry.SDE_SCHEMES[name].name in pt_registry.PORTED:
            continue
        with pytest.raises(NotImplementedError, match="ROADMAP item 8"):
            pt.sdeint(p_drift, p_g["diag"], y0, t, name)
    with pytest.raises(NotImplementedError, match="ROADMAP item 8"):
        pt.sdeint(p_drift, p_g["diag"], y0, t, "euler", adaptive=True)

    # the validation errors, each the JAX package's
    def both(fn_j, fn_p, exc, match):
        with pytest.raises(exc, match=match):
            fn_j()
        with pytest.raises(exc, match=match):
            fn_p()

    j_drift, j_g = _fields(jnp, jnp.asarray)
    jy0, jt = jnp.asarray(_Y0), jnp.asarray(_T[:3])
    plain_j = pj.BrownianInterval(0.0, 1.0, size=(3, 2), dtype=jnp.float64)
    plain_p = pt.BrownianInterval(0.0, 1.0, size=(3, 2), dtype=F64, device="cpu")
    both(lambda: pj.sdeint(j_drift, j_g["diag"], jy0, jt, "sra1", bm=plain_j),
         lambda: pt.sdeint(p_drift, p_g["diag"], y0, t, "sra1", bm=plain_p),
         ValueError, "space-time integral")
    both(lambda: pj.sdeint(j_drift, j_g["diag"], jy0, jt, "foster2", bm=plain_j),
         lambda: pt.sdeint(p_drift, p_g["diag"], y0, t, "foster2", bm=plain_p),
         ValueError, "space-time-time")
    one_d_j = pj.BrownianInterval(0.0, 1.0, size=(2,), dtype=jnp.float64,
                                  levy_area_approximation="davie")
    one_d_p = pt.BrownianInterval(0.0, 1.0, size=(2,), dtype=F64, device="cpu",
                                  levy_area_approximation="davie")
    both(lambda: pj.sdeint(j_drift, j_g["matrix"], jy0[0], jt, "milstein_general", bm=one_d_j),
         lambda: pt.sdeint(p_drift, p_g["matrix"], y0[0], t, "milstein_general", bm=one_d_p),
         ValueError, "at least a batch axis")
    both(lambda: pj.sdeint(j_drift, j_g["matrix"], jy0, jt, "milstein_general", bm=plain_j),
         lambda: pt.sdeint(p_drift, p_g["matrix"], y0, t, "milstein_general", bm=plain_p),
         ValueError, "full Lévy areas")
    both(lambda: pj.sdeint(j_drift, j_g["diag"], jy0, jt, "rk4"),
         lambda: pt.sdeint(p_drift, p_g["diag"], y0, t, "rk4"),
         ValueError, "mis-weight the Brownian increment")
    both(lambda: pj.sdeint(j_drift, j_g["matrix"], jy0, jt, "euler_general"),
         lambda: pt.sdeint(p_drift, p_g["matrix"], y0, t, "euler_general"),
         ValueError, "noise_dim")

    # Itô <-> Stratonovich drifts, each noise contract
    tt = 0.3
    for noise, g_name in (("diagonal", "diag"), ("scalar", "diag"), ("general", "matrix")):
        for conv in ("ito_to_stratonovich", "stratonovich_to_ito"):
            want = getattr(pj, conv)(j_drift, j_g[g_name], noise=noise)(tt, jy0)
            got = getattr(pt, conv)(p_drift, p_g[g_name], noise=noise)(torch.tensor(tt, dtype=F64), y0)
            assert np.max(np.abs(np.asarray(want) - got.numpy())) <= CONVERSION_TOL, (noise, conv)


def test_sdeint_matches_jax():
    """One item (the suite's ``--dist load`` chunks move with the item
    count, ROADMAP "Test placement"): every scheme pathwise, then the
    registry, the refusals, the validation errors and the conversions."""
    _check_every_ported_scheme_pathwise()
    _check_registry_refusals_validation_and_conversions()
