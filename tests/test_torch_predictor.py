"""The port's Predictor against the JAX Predictor on the same parameters and
lags (float32, 1e-4 normalised), its bulk path against its host-window path
(bit for bit), its shape errors, and from_checkpoint on files written in
the JAX Trainer's layout (written directly here, no training)."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddlexde_tpu.models.d3stn import D3STN as JaxD3STN
from paddlexde_tpu.models.d3stn import D3STNConfig as JaxConfig
from paddlexde_tpu.models.d3stn import Predictor as JaxPredictor
from paddlexde_tpu.models.d3stn import norm_adj_matrix
from paddlexde_tpu_torch.models.d3stn import D3STNConfig, Predictor

TOL = 1e-4
N, HIS = 10, 64
KW = dict(num_nodes=N, his_len=HIS, tgt_len=12, encoder_num_layers=1, decoder_num_layers=1,
          d_model=16, d_proj=8, d_sect=4, d_adaptive=0, head=2, top_k=3)


class _Scaler:
    def inverse_transform(self, x):
        return 3.0 * x + 1.0


def _series(rng, t_len):
    s = rng.randn(N, t_len, 3).astype(np.float32)
    steps = np.arange(t_len)
    s[..., 1] = (steps // 288) % 7
    s[..., 2] = steps % 288
    return s


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(0)
    adj = (rng.rand(N, N) < 0.3).astype(np.float32)
    adj = np.maximum(adj, adj.T)
    sc = rng.rand(N, N).astype(np.float32)
    jcfg = JaxConfig(**KW)
    model = JaxD3STN(jcfg, jnp.asarray(norm_adj_matrix(adj).astype(np.float32)),
                     jnp.asarray(norm_adj_matrix(sc).astype(np.float32)))
    x = jnp.zeros((2, N, 12, 3), jnp.float32)
    params = jax.tree.map(np.asarray, model.init(jax.random.key(1), x, x)["params"])
    enc = np.sort(rng.rand(12) * (HIS - 1)).astype(np.float32)
    dec = (HIS - 1 - 1.5 * rng.rand(12)).astype(np.float32)  # last interval, and beyond
    series = _series(rng, HIS + 12)
    windows = np.stack([series[:, s : s + HIS] for s in range(7)])
    want = np.asarray(JaxPredictor(jcfg, params, enc, dec, adj, sc, batch_size=4)(windows))
    return dict(params=params, enc=enc, dec=dec, adj=adj, sc=sc, series=series,
                windows=windows, want=want)


def _port(s, **kw):
    return Predictor(D3STNConfig(**KW), s["params"], s["enc"], s["dec"], s["adj"], s["sc"],
                     batch_size=4, device="cpu", **kw)


def test_matches_jax_predictor_on_a_ragged_batch(setup):
    got = _port(setup).warmup()(setup["windows"])  # 7 = 4 + 3
    want = setup["want"]
    assert got.shape == want.shape == (7, N, 12)
    assert np.abs(got - want).max() / np.abs(want).max() <= TOL


def test_scaler_is_applied(setup):
    got = _port(setup, scaler=_Scaler())(setup["windows"])
    want = 3.0 * setup["want"] + 1.0
    assert np.abs(got - want).max() / np.abs(want).max() <= TOL


def test_predict_series_equals_host_windows_bit_for_bit(setup):
    pred = _port(setup)
    starts = [0, 3, 6, 1, 2, 5, 4]
    got = pred.predict_series(setup["series"], starts)
    host = np.stack([setup["series"][:, s : s + HIS] for s in starts])
    np.testing.assert_array_equal(got, pred(host))
    assert pred.predict_series(setup["series"], []).shape == (0, N, 12)


def test_shape_errors(setup):
    pred = _port(setup)
    with pytest.raises(ValueError, match="does not match"):
        pred(setup["windows"][:, :, : HIS - 1])
    with pytest.raises(ValueError, match="does not match"):
        pred.predict_series(setup["series"][:, :, :2], [0])
    with pytest.raises(ValueError, match="out of range"):
        pred.predict_series(setup["series"], [setup["series"].shape[1]])
    with pytest.raises(ValueError, match="out of range"):
        pred.predict_series(setup["series"], [-1])


def test_from_checkpoint_reads_the_trainer_layout(setup, tmp_path):
    for tag in ("epoch_best", "epoch_3"):
        with open(os.path.join(tmp_path, f"{tag}.params"), "wb") as f:
            pickle.dump(setup["params"], f)
        np.save(os.path.join(tmp_path, f"{tag}.enidx.npy"), setup["enc"])
        np.save(os.path.join(tmp_path, f"{tag}.deidx.npy"), setup["dec"])
    cfg = D3STNConfig(**KW)
    direct = _port(setup)(setup["windows"])
    for epoch in (None, 3):
        pred = Predictor.from_checkpoint(cfg, str(tmp_path), setup["adj"], setup["sc"],
                                         epoch=epoch, batch_size=4, device="cpu")
        np.testing.assert_array_equal(pred(setup["windows"]), direct)
    with pytest.raises(FileNotFoundError, match="layout"):
        Predictor.from_checkpoint(cfg, str(tmp_path), setup["adj"], setup["sc"], epoch=9,
                                  device="cpu")
