"""The port's D3STN forward against the JAX model on the same parameters
(loaded from the flax tree by ``load_flax_params``), float32, to 1e-4
normalised max-abs error. Two known sources of float32 difference sit well
inside it: flax's LayerNorm takes the variance as E[x^2] - E[x]^2 where
torch uses two passes (~1e-6 relative), and the port applies the top-k mix
before the temporal conv (the JAX plain path after it; equal in exact
arithmetic because the mix is row-stochastic)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlexde_tpu.models.d3stn import D3STN as JaxD3STN
from paddlexde_tpu.models.d3stn import D3STNConfig as JaxConfig
from paddlexde_tpu.models.d3stn import model as jax_model
from paddlexde_tpu_torch.models.d3stn import D3STN, D3STNConfig, load_flax_params
from paddlexde_tpu_torch.models.d3stn import norm_adj_matrix, topk_mix_matrix


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs 6 workers on 8 cores: torch's default of one compute
    thread per core in each worker (spinning between the tiny ops here)
    would take cores from the JAX tests beside it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


TOL = 1e-4
N = 10


def _cfg_kwargs(**kw):
    base = dict(num_nodes=N, his_len=64, tgt_len=12, encoder_num_layers=1,
                decoder_num_layers=1, d_model=16, d_proj=8, d_sect=4, d_adaptive=0,
                head=2, top_k=3)
    base.update(kw)
    return base


def _graph(seed, sparse_sc=False):
    rng = np.random.RandomState(seed)
    adj = (rng.rand(N, N) < 0.3).astype(np.float32)
    adj = np.maximum(adj, adj.T)
    if sparse_sc:  # a sparse normalised adjacency: rows of mostly tied zeros
        sc = (rng.rand(N, N) < 0.2).astype(np.float32)
    else:
        sc = rng.rand(N, N).astype(np.float32)
    return (norm_adj_matrix(adj).astype(np.float32), norm_adj_matrix(sc).astype(np.float32))


def _inputs(seed, b=3):
    rng = np.random.RandomState(seed)

    def one():
        x = rng.randn(b, N, 12, 3).astype(np.float32)
        x[..., 1] = rng.randint(0, 7, (b, N, 12)) + rng.rand(b, N, 12) * 0.9
        x[..., 2] = rng.randint(0, 288, (b, N, 12)) + rng.rand(b, N, 12) * 0.9
        return x

    return one(), one()


def _compare(kwargs, seed, sparse_sc=False):
    adj, sc = _graph(seed, sparse_sc)
    jcfg, tcfg = JaxConfig(**kwargs), D3STNConfig(**kwargs)
    jm = JaxD3STN(jcfg, jnp.asarray(adj), jnp.asarray(sc))
    src, tgt = _inputs(seed)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(seed), jnp.asarray(src), jnp.asarray(tgt))["params"])
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(src), jnp.asarray(tgt)), np.float64)
    tm = D3STN(tcfg, adj, sc, device="cpu").eval()
    load_flax_params(tm, params)
    with torch.no_grad():
        got = tm(torch.tensor(src), torch.tensor(tgt)).numpy().astype(np.float64)
    assert got.shape == want.shape == (3, N, 12, 1)
    assert np.isfinite(got).all()
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("with_adj,with_sc", [(1, 1), (0, 1)])
@pytest.mark.parametrize("attention", ["Corr", "Vanilla"])
def test_forward_matches_jax(attention, with_adj, with_sc):
    kwargs = _cfg_kwargs(attention=attention, with_adj=bool(with_adj), with_sc=bool(with_sc))
    assert _compare(kwargs, seed=with_adj + 2 * (attention == "Corr")) <= TOL


def test_forward_matches_jax_two_layers_adaptive_embedding():
    kwargs = _cfg_kwargs(encoder_num_layers=2, decoder_num_layers=2, d_proj=4, d_adaptive=4)
    assert _compare(kwargs, seed=11) <= TOL


def test_topk_ties_follow_lax_top_k():
    row = np.array([0.0, 1.0, 0.0, 0.0, 1.0, 0.0], np.float32)
    mat = np.stack([np.roll(row, i) for i in range(6)])  # square, every row tied
    want = np.asarray(jax_model._topk_mix_matrix(jnp.asarray(mat), 4))
    got = topk_mix_matrix(torch.tensor(mat), 4).numpy()
    assert np.array_equal(np.nonzero(got[0])[0], [0, 1, 2, 4])  # lax.top_k keeps [1, 4, 0, 2]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    _, sc = _graph(5, sparse_sc=True)
    want = np.asarray(jax_model._topk_mix_matrix(jnp.asarray(sc), 3))
    np.testing.assert_allclose(topk_mix_matrix(torch.tensor(sc), 3).numpy(), want,
                               rtol=1e-6, atol=1e-7)


def test_forward_matches_jax_with_tied_correlations():
    assert _compare(_cfg_kwargs(top_k=4), seed=5, sparse_sc=True) <= TOL


def test_load_flax_params_rejects_a_mismatched_tree():
    kwargs = _cfg_kwargs()
    adj, sc = _graph(0)
    jm = JaxD3STN(JaxConfig(**kwargs), jnp.asarray(adj), jnp.asarray(sc))
    src, tgt = _inputs(0)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(0), jnp.asarray(src), jnp.asarray(tgt)))
    tm = D3STN(D3STNConfig(**kwargs), adj, sc, device="cpu")
    load_flax_params(tm, params)  # the outer {"params": ...} wrapper is accepted
    del params["params"]["generator"]
    with pytest.raises(KeyError, match="generator"):
        load_flax_params(tm, params)
