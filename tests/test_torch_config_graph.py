"""The port's configuration loading, initial lags and graph helpers against
the JAX package's, on the CPU (both sides are numpy and plain Python, so
they agree exactly):

- each shipped configuration (``examples/configs``) loads to the same
  field values, with overrides, boolean flags and unknown keys handled
  alike;
- the initial lag anchors on each of their three history ranges;
- an edge list, one- and two-direction, with and without an id map, and a
  ``.npy`` matrix load to the same matrices;
- the row-, symmetric- and per-channel-normalised adjacencies.
"""

import dataclasses
import os

import numpy as np
import pytest

from paddlexde_tpu.models.d3stn import config as jax_config
from paddlexde_tpu.models.d3stn import graph as jax_graph
from paddlexde_tpu.models.d3stn import trainer as jax_trainer
from paddlexde_tpu_torch.models.d3stn import config, graph
from paddlexde_tpu_torch.models.d3stn.trainer import init_lag_anchors

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "examples", "configs")


@pytest.mark.parametrize("name", ["HZME_INFLOW", "HZME_OUTFLOW", "PEMS03", "PEMS04", "PEMS07",
                                  "PEMS08", "SYNTH"])
def test_shipped_config_loads_as_in_jax(name):
    path = os.path.join(CONFIGS, f"{name}.json")
    for overrides in ({}, dict(batch_size=3, with_adj=0, dropout=0.1, not_a_field=1)):
        got = dataclasses.asdict(config.load_config(path, **overrides))
        want = dataclasses.asdict(jax_config.load_config(path, **overrides))
        assert set(got) <= set(want)
        assert got == {k: want[k] for k in got}
        assert isinstance(got["with_adj"], bool) and isinstance(got["with_sc"], bool)
    assert got["batch_size"] == 3 and got["with_adj"] is False and "not_a_field" not in got


# below a day of 5-minute steps, a day and more, a week and more
@pytest.mark.parametrize("his_len", [24, 288, 2016])
def test_initial_lags_match_jax(his_len):
    enc, dec = init_lag_anchors(config.D3STNConfig(his_len=his_len, tgt_len=12))
    want_enc, want_dec = jax_trainer.init_lag_anchors(
        jax_config.D3STNConfig(his_len=his_len, tgt_len=12))
    assert enc.dtype == dec.dtype == np.float32
    assert np.array_equal(enc, want_enc) and np.array_equal(dec, want_dec)
    assert enc.shape == (12,) and 0 <= enc.min() and enc.max() < his_len
    assert (dec == his_len - 1).all()


def _edge_list(tmp_path, id_map):
    """Six nodes, five directed edges with distances; ids remapped from
    sensor numbers through an id file when ``id_map``."""
    ids = [401, 17, 230, 5, 912, 64]
    edges = [(0, 1, 3.5), (1, 2, 0.25), (3, 0, 7.0), (4, 5, 1.5), (5, 3, 2.0)]
    name = (lambda i: ids[i]) if id_map else (lambda i: i)
    path = tmp_path / "edges.csv"
    path.write_text("from,to,cost\n" + "".join(f"{name(i)},{name(j)},{d}\n" for i, j, d in edges))
    id_file = None
    if id_map:
        id_file = tmp_path / "ids.txt"
        id_file.write_text("\n".join(str(i) for i in ids) + "\n")
        id_file = str(id_file)
    return str(path), id_file


@pytest.mark.parametrize("id_map", [False, True])
@pytest.mark.parametrize("loader", ["get_adjacency_matrix", "get_adjacency_matrix_2direction"])
def test_edge_list_loads_as_in_jax(tmp_path, loader, id_map):
    path, id_file = _edge_list(tmp_path, id_map)
    a, dist = getattr(graph, loader)(path, 6, id_file)
    want_a, want_dist = getattr(jax_graph, loader)(path, 6, id_file)
    assert a.dtype == dist.dtype == np.float32 and a.shape == dist.shape == (6, 6)
    assert np.array_equal(a, want_a) and np.array_equal(dist, want_dist)
    assert a.sum() == (10 if loader.endswith("2direction") else 5)
    assert dist[0, 1] == 3.5 and dist[4, 5] == 1.5


def test_npy_matrix_loads_as_in_jax(tmp_path):
    w = np.random.RandomState(0).rand(7, 7).astype(np.float32)
    path = str(tmp_path / "adj.npy")
    np.save(path, w)
    for loader in ("get_adjacency_matrix", "get_adjacency_matrix_2direction"):
        a, dist = getattr(graph, loader)(path, 7)
        want_a, want_dist = getattr(jax_graph, loader)(path, 7)
        assert dist is None and want_dist is None
        assert np.array_equal(a, want_a) and np.array_equal(a, w)


@pytest.mark.parametrize("norm", ["norm_adj_matrix", "sym_norm_adj", "multichannel_norm_adj"])
def test_normalised_adjacency_matches_jax(norm):
    rng = np.random.RandomState(1)
    w = (rng.rand(3, 9, 9) < 0.4).astype(np.float32) * rng.rand(3, 9, 9).astype(np.float32)
    w = w if norm == "multichannel_norm_adj" else w[0]
    got, want = getattr(graph, norm)(w), getattr(jax_graph, norm)(w)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if norm != "sym_norm_adj":
        np.testing.assert_allclose(got.sum(axis=-1), 1.0, rtol=1e-6)
    if norm != "multichannel_norm_adj":
        with pytest.raises(ValueError, match="square"):
            getattr(graph, norm)(w[:, :4])
