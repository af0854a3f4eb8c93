"""The port's threefry PRNG and virtual Brownian tree against JAX, on the CPU.

The same key (an int, or a JAX key's words through ``key_from_jax``) goes
to both packages. Tolerances:

- keys (``key``, ``fold_in``, ``split``), 32- and 64-bit random bits and
  the float32/float64 uniforms: bit for bit;
- normals: within NORMAL_ULPS ulps of ``jax.random.normal`` (the port's
  ``log1p`` and XLA's, and XLA's FMA contraction of the ``erf_inv``
  polynomial, round apart; measured at most 3 ulps over 4e5 draws in each
  dtype), and the port's ``erf_inv`` within the same ulps of
  ``jax.lax.erf_inv``;
- the tree (W, U, K, the Davie, Foster and Fourier areas, J3, W pinning,
  ``ReverseBrownian``, ``AntitheticBrownian``, ``BrownianPath`` and
  ``BrownianTree``): TREE_TOL in float64 (the port runs the JAX recurrence
  on coefficients and contracts once; the sums associate apart, measured
  ~3e-15).

Two controls must fail the same comparisons: a uniform without JAX's
``nextafter(-1, 0)`` lower bound, and a per-query key that folds the two
halves of a float64 time in the wrong order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddlexde_tpu.brownian as jb
import paddlexde_tpu_torch.brownian as pb
from paddlexde_tpu_torch.brownian import prng, virtual_tree

F64 = torch.float64
NORMAL_ULPS = 4
TREE_TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _float64_one_thread():
    x64, threads = jax.config.jax_enable_x64, torch.get_num_threads()
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(1)
    yield
    jax.config.update("jax_enable_x64", x64)
    torch.set_num_threads(threads)


def _words(k):
    return np.asarray(jax.random.key_data(k))


def _ulps(a, b):
    it = np.int32 if a.dtype == np.float32 else np.int64
    return np.abs(a.view(it).astype(np.int64) - b.view(it).astype(np.int64))


def _check_threefry_bits_uniforms_and_normals():
    for seed in (0, 42, 123456789, 2**40 + 5):
        jk, pk = jax.random.key(seed), prng.key(seed)
        assert (_words(jk) == pk.data).all(), seed
        for data in (0, 1, 3, 2**31 + 7, 2**32 - 1):
            assert (_words(jax.random.fold_in(jk, data)) == prng.fold_in(pk, data).data).all()
        for jsub, psub in zip(jax.random.split(jk, 5), prng.split(pk, 5)):
            assert (_words(jsub) == psub.data).all()
        for shape in ((), (7,), (3, 5), (4, 2, 3)):
            want32 = np.asarray(jax.random.bits(jk, shape, jnp.uint32))
            assert (prng.random_bits(pk, 32, shape).numpy().astype(np.uint32) == want32).all()
            want64 = np.asarray(jax.random.bits(jk, shape, jnp.uint64))
            got64 = prng.random_bits(pk, 64, shape).numpy().view(np.uint64)
            assert (got64 == want64).all()
            for jdt, tdt in ((jnp.float32, torch.float32), (jnp.float64, F64)):
                want = np.asarray(jax.random.uniform(jk, shape, jdt))
                assert (_ulps(want, prng.uniform(pk, shape, tdt).numpy()) == 0).all()
    # a JAX key object, through its words
    jk = jax.random.fold_in(jax.random.key(9), 77)
    pk = prng.key_from_jax(_words(jk))
    n = 20000
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.float64, F64)):
        want = np.asarray(jax.random.normal(jk, (n,), jdt))
        got = prng.normal(pk, (n,), tdt).numpy()
        assert _ulps(want, got).max() <= NORMAL_ULPS, (jdt, _ulps(want, got).max())
        # a batch of keys in one call: row r is normal(keys[r])
        keys = [prng.fold_in(pk, r) for r in range(3)]
        rows = prng.normal_rows(keys, (5, 4), tdt).numpy()
        for r in range(3):
            w = np.asarray(jax.random.normal(jax.random.fold_in(jk, r), (5, 4), jdt))
            assert _ulps(w, rows[r]).max() <= NORMAL_ULPS
        # XLA's erf_inv at the normal's own uniforms
        lo = np.nextafter(np.array(-1.0, jdt), np.array(0.0, jdt))
        u = np.asarray(jax.random.uniform(jk, (n,), jdt, lo, 1.0))
        want_e = np.asarray(jax.lax.erf_inv(jnp.asarray(u)))
        got_e = prng.erf_inv(torch.from_numpy(u.copy())).numpy()
        assert _ulps(want_e, got_e).max() <= NORMAL_ULPS
        # the control: without the nextafter lower bound the same comparison fails
        b1, b2 = prng._hash_rows(pk.data[None], (n,), torch.device("cpu"))
        unbounded = prng._scale_uniform(prng._unit_floats(b1, b2, tdt), -1.0, 1.0, tdt)
        control = (prng.erf_inv(unbounded) * float(np.sqrt(np.array(2.0, jdt))))[0].numpy()
        assert _ulps(want, control).max() > NORMAL_ULPS


def _pairs(x, y):
    x = x if isinstance(x, tuple) else (x,)
    y = y if isinstance(y, tuple) else (y,)
    assert len(x) == len(y)
    return [float(np.max(np.abs(np.asarray(a) - b.numpy()))) if np.size(a) else 0.0
            for a, b in zip(x, y)]


# the richest query of each mode (a Lévy-configured interval routes every
# query through the same descent, so W and U of the plain queries are these)
_MODES = {
    "none": {},
    "space-time": {"return_U": True},
    "space-time-time": {"return_U": True, "return_K": True},
    "davie": {"return_U": True, "return_A": True},
    "foster": {"return_U": True, "return_A": True},
    "fourier": {"return_U": True, "return_A": True, "return_J3": True},
}
# the second interval ends at 0: its reversed query ends at -0.0
_INTERVALS = ((0.3, 0.7125), (0.0, 0.3))
_SIZE = (3, 2)


def _jax_tree_outputs():
    """Every mode's richest query, plain, reversed and antithetic, over each
    interval: one compilation per mode (the times traced)."""
    out = {}
    for mode, kw in _MODES.items():
        jbm = jb.BrownianInterval(0.0, 2.0, size=_SIZE, dtype=jnp.float64, key=5,
                                  levy_area_approximation=mode)

        def queries(ta, tb, jbm=jbm, kw=kw):
            return (jbm(ta, tb, **kw), jb.ReverseBrownian(jbm)(-tb, -ta, **kw),
                    jb.AntitheticBrownian(jbm)(ta, tb, **kw))

        fn = jax.jit(queries)
        for ta, tb in _INTERVALS:
            plain, rev, anti = fn(jnp.float64(ta), jnp.float64(tb))
            out[mode, "plain", ta, tb] = plain
            out[mode, "reverse", -tb, -ta] = rev
            out[mode, "antithetic", ta, tb] = anti
    return out


def _tree_errors(jax_out):
    errs = []
    for mode, kw in _MODES.items():
        pbm = pb.BrownianInterval(0.0, 2.0, size=_SIZE, dtype=F64, key=5,
                                  levy_area_approximation=mode, device="cpu")
        wraps = {"plain": pbm, "reverse": pb.ReverseBrownian(pbm),
                 "antithetic": pb.AntitheticBrownian(pbm)}
        for name, bm in wraps.items():
            for ta, tb in _INTERVALS:
                if name == "reverse":
                    ta, tb = -tb, -ta
                errs += _pairs(jax_out[mode, name, ta, tb], bm(ta, tb, **kw))
    return errs


def _check_brownian_tree_in_every_mode():
    jax_out = _jax_tree_outputs()
    assert max(_tree_errors(jax_out)) <= TREE_TOL
    # W pinning with a tol-derived depth and a single-argument query; a JAX
    # key object; BrownianPath's w0 offset and BrownianTree's tol (the JAX
    # side in one compilation)
    w0 = np.array([0.5, -1.0])
    jk = jax.random.fold_in(jax.random.key(9), 77)
    pk = prng.key_from_jax(_words(jk))

    @jax.jit
    def extras(t02, t09, t04):
        pinned = jb.BrownianInterval(0.0, 1.0, size=(4,), dtype=jnp.float64, key=3,
                                     W=np.arange(4.0), tol=1e-3)
        return (pinned(t02, t09), pinned(0.0, 1.0), pinned(t04),
                jb.BrownianInterval(0.0, 1.0, size=(5,), dtype=jnp.float64, key=jk)(0.1, 0.2),
                jb.BrownianPath(0.0, w0=w0, dtype=jnp.float64, key=2)(0.6),
                jb.BrownianTree(0.0, w0=w0, t1=2.0, entropy=4, dtype=jnp.float64)(0.3, 1.7))

    want = extras(jnp.float64(0.2), jnp.float64(0.9), jnp.float64(0.4))
    pinned = pb.BrownianInterval(0.0, 1.0, size=(4,), dtype=F64, key=3,
                                 W=torch.arange(4.0, dtype=F64), tol=1e-3, device="cpu")
    got = (pinned(0.2, 0.9), pinned(0.0, 1.0), pinned(0.4),
           pb.BrownianInterval(0.0, 1.0, size=(5,), dtype=F64, key=pk, device="cpu")(0.1, 0.2),
           pb.BrownianPath(0.0, w0=torch.tensor(w0), dtype=F64, key=2, device="cpu")(0.6),
           pb.BrownianTree(0.0, w0=torch.tensor(w0), t1=2.0, entropy=4, dtype=F64,
                           device="cpu")(0.3, 1.7))
    errs = [e for a, b in zip(want, got) for e in _pairs(a, b)]
    assert max(errs) <= TREE_TOL
    # the leading rows of a batch are a smaller batch's path with the same
    # key, in every output; a float64 tree under _noise_dtype(float32)
    # follows the float32 tree's path (to float32 rounding, measured 7e-7 of
    # values ~1; at a depth of 12, where float32 still resolves the
    # midpoints), where without it the path differs by O(1) (the card's
    # float64 references rest on both)
    def query(rows, dtype):
        return pb.BrownianInterval(0.0, 1.0, size=(rows, 2), dtype=dtype, key=1, device="cpu",
                                   tol=2.0**-12, levy_area_approximation="davie")(
            0.1, 0.4, return_U=True, return_A=True)

    full = query(6, F64)
    assert all(torch.equal(f[:2], p) for f, p in zip(full, query(2, F64)))
    f32 = query(6, torch.float32)
    with virtual_tree._noise_dtype(torch.float32):
        f64 = query(6, F64)
    assert max(float((a.double() - b).abs().max()) for a, b in zip(f32, f64)) <= 1e-5
    assert float((f64[0] - full[0]).abs().max()) > 1e-1

    # the control: the per-query key folding a float64 time's halves in the
    # wrong order draws other areas, and the same comparison catches it
    right = virtual_tree._query_key

    def swapped(key, ta, tb):
        def fold_time(k, t):
            bits = int(np.asarray(np.float64(virtual_tree.host_time(t)) + 0.0).view(np.uint64))
            return prng.fold_in(prng.fold_in(k, bits >> 32), bits & 0xFFFFFFFF)

        return fold_time(fold_time(key, ta), tb)

    virtual_tree._query_key = swapped
    try:
        assert max(_tree_errors(jax_out)) > 1e-3
    finally:
        virtual_tree._query_key = right


def test_threefry_and_brownian_tree_match_jax():
    """One item (the suite's ``--dist load`` chunks move with the item
    count, ROADMAP "Test placement"): the PRNG, then the tree."""
    _check_threefry_bits_uniforms_and_normals()
    _check_brownian_tree_in_every_mode()
