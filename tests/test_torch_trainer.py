"""The port's D3STN Trainer against the JAX Trainer on the same flax
parameters, lags and windows (float32, on the CPU's plain versions):

- loss, alignment term and every gradient leaf against JAX's jitted
  ``value_and_grad(_loss_fn)``: loss to 1e-5 relative, gradients to 1e-4
  normalised max-abs per leaf (float32 sums in other orders, flax's one-pass
  LayerNorm variance; the key-conv bias gradients, zero in exact arithmetic,
  against the scale of their module's other bias gradients);
- one Adam update against a numpy optax oracle on the port's own gradients,
  to rtol 1e-5;
- the lag clip and both cases of the non-finite guard
  (``tests/models/test_lag_clamp.py``);
- window starts, window contents, the schedules and the metrics equal to
  the JAX package's;
- checkpoints: the port's load in the JAX package and give its forecasts,
  and the reverse, to 1e-4 normalised.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlexde_tpu.models.d3stn import D3STN as JaxD3STN
from paddlexde_tpu.models.d3stn import D3STNConfig as JaxConfig
from paddlexde_tpu.models.d3stn import Predictor as JaxPredictor
from paddlexde_tpu.models.d3stn import Trainer as JaxTrainer
from paddlexde_tpu.models.d3stn import TrafficFlowDataset as JaxDataset
from paddlexde_tpu.models.d3stn import metrics as jax_metrics
from paddlexde_tpu.models.d3stn import synthetic_traffic_npz
from paddlexde_tpu.models.d3stn import train_utils as jax_utils
from paddlexde_tpu_torch.models.d3stn import (
    MAE,
    MAPE,
    MSE,
    RMSE,
    D3STNConfig,
    Predictor,
    TrafficFlowDataset,
    Trainer,
    smis,
)
from paddlexde_tpu_torch.models.d3stn import train_utils
from paddlexde_tpu_torch.models.d3stn.weights import _flax_to_state_dict, load_flax_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs 6 workers on 8 cores: torch's default of one compute
    thread per core in each worker (spinning between the tiny ops here)
    would take cores from the JAX tests beside it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


N, HIS, B = 8, 64, 4
KW = dict(dataset_name="SYNTH", num_nodes=N, his_len=HIS, tgt_len=12, encoder_num_layers=1,
          decoder_num_layers=1, d_model=16, d_proj=8, d_sect=4, d_adaptive=0, head=2,
          top_k=3, attention="Corr", batch_size=B, train_epochs=1, finetune_epochs=0,
          warmup_step=1, decay_step=2, patience=5, loss="mae", kl_loss_weight=0.01)
KL = 0.37


def _norm_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainers")
    data = synthetic_traffic_npz(num_nodes=N, seq_len=288 * 2)
    rng = np.random.RandomState(0)
    adj = (rng.rand(N, N) < 0.3).astype(np.float32)
    adj = np.maximum(adj, adj.T)
    sc = rng.rand(N, N).astype(np.float32)
    jcfg = JaxConfig(**KW, save_dir=str(root / "jax"))
    # the Trainer initialises flax eagerly, one compile per operation (~8-13 s
    # on the CPU); one jitted init gives the same parameters in ~3 s
    init = JaxD3STN.init
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxD3STN, "init",
                   lambda self, key, *xs: jax.jit(lambda k, *a: init(self, k, *a))(key, *xs))
        jtr = JaxTrainer(jcfg, data=data, adj_matrix=adj, sc_matrix=sc)
    # lags off the knots, so the spline's lag gradients are not at a corner
    enc = (np.arange(HIS - 12, HIS) - 0.5 - 3 * rng.rand(12)).astype(np.float32)
    dec = (HIS - 1 - 2 * rng.rand(12)).astype(np.float32)
    jtr.encoder_idx, jtr.decoder_idx = jnp.asarray(enc), jnp.asarray(dec)
    s_b = next(jtr.train_dataset.batch_starts(B, shuffle=True, seed=3))
    ds = jtr.train_dataset
    src = np.stack([ds.data[:, s : s + HIS] for s in s_b])
    tgt = np.stack([ds.data[:, s + HIS : s + HIS + 12] for s in s_b])
    params = jax.tree.map(np.asarray, jtr.params)
    return dict(root=root, data=data, adj=adj, sc=sc, jtr=jtr, params=params, enc=enc,
                dec=dec, s_b=s_b, src=src, tgt=tgt)


def _port(s, name="torch", from_jax=True):
    tr = Trainer(D3STNConfig(**KW, save_dir=str(s["root"] / name)), data=s["data"],
                 adj_matrix=s["adj"], sc_matrix=s["sc"], device="cpu")
    if not from_jax:  # the port's own random initialisation and anchor lags
        return tr
    load_flax_params(tr.model, s["params"])
    with torch.no_grad():
        tr.encoder_idx.copy_(torch.tensor(s["enc"]))
        tr.decoder_idx.copy_(torch.tensor(s["dec"]))
    return tr


def _port_grads(tr, src, tgt, kl):
    total, loss, align = tr.loss_fn(torch.tensor(src), torch.tensor(tgt), kl)
    grads = torch.autograd.grad(total, tr.state_tensors(), materialize_grads=True)
    return total, loss, align, dict(zip(tr.state_names, grads))


def test_loss_and_gradients_match_jax(setup):
    s, tr = setup, _port(setup)
    fn = jax.jit(jax.value_and_grad(s["jtr"]._loss_fn, has_aux=True))
    (total_j, (loss_j, align_j)), grads_j = fn(
        s["jtr"].state, jnp.asarray(s["src"]), jnp.asarray(s["tgt"]),
        jnp.asarray(KL, jnp.float32))
    total, loss, align, grads = _port_grads(tr, s["src"], s["tgt"], KL)
    for got, want in ((total, total_j), (loss, loss_j), (align, align_j)):
        assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    want = _flax_to_state_dict(jax.tree.map(np.asarray, grads_j["net"]))
    want["enc_idx"], want["dec_idx"] = grads_j["enc_idx"], grads_j["dec_idx"]
    assert set(want) == set(grads)
    errs = {}
    for k in grads:
        scale = np.abs(want[k]).max()
        if k.endswith("key_conv.bias"):
            # zero in exact arithmetic (a constant added to every key leaves
            # the softmax unchanged): scaled by the module's other conv biases
            prefix = k[: -len("key_conv.bias")]
            scale = max(np.abs(want[prefix + c + "_conv.bias"]).max()
                        for c in ("query", "value", "out"))
        errs[k] = np.abs(grads[k].numpy() - np.asarray(want[k])).max() / scale
    assert max(errs.values()) <= 1e-4, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    assert np.abs(grads["enc_idx"].numpy()).max() > 0 and np.abs(grads["dec_idx"].numpy()).max() > 0


def test_one_adam_step_matches_the_numpy_optax_oracle(setup):
    s, tr = setup, _port(setup)
    before = [t.detach().clone().numpy().astype(np.float64) for t in tr.state_tensors()]
    *_, grads = _port_grads(tr, s["src"], s["tgt"], KL)
    lr_net, lr_lags = 1.3e-3, 2.7e-4
    loss, _ = tr.train_step(torch.tensor(s["src"]), torch.tensor(s["tgt"]), KL, lr_net, lr_lags)
    assert np.isfinite(loss.item()) and int(tr.opt_state["count"]) == 1
    b1, b2, eps = 0.9, 0.999, 1e-8
    for name, old, new in zip(tr.state_names, before, tr.state_tensors()):
        g = grads[name].numpy().astype(np.float64)
        mu_hat = ((1 - b1) * g) / (1 - b1)
        nu_hat = ((1 - b2) * g * g) / (1 - b2)
        lr = lr_lags if name in ("enc_idx", "dec_idx") else lr_net
        want = old - lr * mu_hat / (np.sqrt(nu_hat) + eps)
        if name in ("enc_idx", "dec_idx"):
            want = np.clip(want, 0.0, HIS - 1)
        np.testing.assert_allclose(new.detach().numpy(), want, rtol=1e-5, atol=1e-7,
                                   err_msg=name)


def test_lags_stay_in_domain_under_huge_lr(setup):
    tr = _port(setup)
    enc0 = tr.encoder_idx.detach().clone()
    for _ in range(3):
        loss, _ = tr.train_step_idx(setup["s_b"], 0.0, 1e-3, 1e3)
        assert np.isfinite(loss.item())
    for lags in (tr.encoder_idx, tr.decoder_idx):
        assert torch.isfinite(lags).all() and lags.min() >= 0.0 and lags.max() <= HIS - 1
    assert not torch.allclose(tr.encoder_idx, enc0)


def _snapshot(tr):
    return ([t.detach().clone() for t in tr.state_tensors()],
            {k: v.clone() for k, v in tr.opt_state.items()})


def _same_bits(a, b):
    a, b = a.detach(), b.detach()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _assert_kept(tr, snap):
    state, opt = snap
    for a, b in zip(state, tr.state_tensors()):
        assert _same_bits(a, b)
    for k, v in opt.items():
        assert _same_bits(v, tr.opt_state[k])


def test_nonfinite_loss_skips_the_update(setup):
    tr = _port(setup)
    snap = _snapshot(tr)
    loss, _ = tr.train_step_idx(setup["s_b"], float("nan"), 1e-3, 1e-4)  # NaN total
    assert not np.isfinite(loss.item())
    _assert_kept(tr, snap)
    loss, _ = tr.train_step_idx(setup["s_b"], 0.0, 1e-3, 1e-4)
    assert np.isfinite(loss.item())
    assert any(not torch.equal(a, b.detach()) for a, b in zip(snap[0], tr.state_tensors()))


def test_finite_loss_nonfinite_moment_skips_the_update(setup):
    tr = _port(setup)
    tr.opt_state["mu"][:5] = float("nan")  # a poisoned first moment, finite loss
    snap = _snapshot(tr)
    loss, _ = tr.train_step_idx(setup["s_b"], 0.0, 1e-3, 1e-4)
    assert not np.isfinite(loss.item())
    _assert_kept(tr, snap)
    assert all(torch.isfinite(t).all() for t in tr.state_tensors())


@pytest.mark.parametrize("name,split", [("SYNTH", "train"), ("SYNTH", "test"),
                                        ("HZME_OUTFLOW", "val")])
def test_windows_and_batches_match_the_jax_dataset(setup, name, split):
    cfg = dict(KW, dataset_name=name)
    jds = JaxDataset(JaxConfig(**cfg), split, data=setup["data"])
    tds = TrafficFlowDataset(D3STNConfig(**cfg), split, data=setup["data"])
    assert tds.windows == jds.windows and len(tds) > 0
    np.testing.assert_array_equal(tds.data, jds.data)
    kw = dict(shuffle=True, seed=5, drop_last=True)
    got, want = list(tds.batch_starts(B, **kw)), list(jds.batch_starts(B, **kw))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for (h, t), (jh, jt) in zip(tds.batches(B, **kw), jds.batches(B, **kw)):
        np.testing.assert_array_equal(h, jh)
        np.testing.assert_array_equal(t, jt)


def test_device_windows_equal_host_windows(setup):
    tr = _port(setup)
    src, tgt = tr.windows(setup["s_b"])
    np.testing.assert_array_equal(src.numpy(), setup["src"])
    np.testing.assert_array_equal(tgt.numpy(), setup["tgt"])


def test_schedules_metrics_and_kl_match_jax():
    for name in ("cosine_annealing_with_warmup", "linear_annealing_with_warmup"):
        mine = getattr(train_utils, name)(1.0, 0.1, 5, 30)
        ref = getattr(jax_utils, name)(1.0, 0.1, 5, 30)
        assert [mine(e) for e in range(40)] == [ref(e) for e in range(40)]
    rng = np.random.RandomState(1)
    y_true = rng.rand(20, 8, 300).astype(np.float32) * 3
    y_pred = y_true + rng.randn(20, 8, 300).astype(np.float32) * 0.3
    pairs = ((MAE, jax_metrics.MAE), (MSE, jax_metrics.MSE), (RMSE, jax_metrics.RMSE))
    for mine, ref in pairs:
        assert mine(y_true, y_pred) == ref(y_true, y_pred)
    assert MAPE(y_true, y_pred, 0.9) == jax_metrics.MAPE(y_true, y_pred, 0.9)
    t2, p2 = y_true.reshape(20, -1), y_pred.reshape(20, -1)
    assert smis(t2, p2, m=288) == jax_metrics.smis(t2, p2, m=288)
    log_q = np.log(np.clip(rng.dirichlet(np.ones(12), 5), 1e-6, None)).astype(np.float32)
    p = rng.dirichlet(np.ones(12), 5).astype(np.float32)
    p[0, 3] = 0.0
    want = float(jax_utils.kl_div(jnp.asarray(log_q), jnp.asarray(p)))
    got = train_utils.kl_div(torch.tensor(log_q), torch.tensor(p)).item()
    assert abs(got - want) <= 1e-6 * abs(want)


def test_checkpoints_cross_between_the_packages(setup):
    s = setup
    series = TrafficFlowDataset(D3STNConfig(**KW), "test", data=s["data"]).data
    windows = np.stack([series[:, k : k + HIS] for k in range(3)])
    jcfg = dataclasses.replace(s["jtr"].cfg)
    # the port writes, the JAX package reads
    tr = _port(s, "torch_ckpt")
    tr.train_step_idx(s["s_b"], KL, 1e-3, 1e-2)  # move off the flax parameters
    tr.save(full_state=True, at_epoch=0)
    jax_pred = JaxPredictor.from_checkpoint(jcfg, tr.save_path, s["adj"], s["sc"], batch_size=B)
    port_pred = Predictor.from_checkpoint(D3STNConfig(**KW), tr.save_path, s["adj"], s["sc"],
                                          batch_size=B, device="cpu")
    want = np.asarray(jax_pred(windows))
    assert _norm_err(port_pred(windows), want) <= 1e-4
    # and a trainer reads back its full state
    tr2 = _port(s, "torch_ckpt")
    tr2.load()
    assert tr2.resume_epoch == 1 and int(tr2.opt_state["count"]) == 1
    for a, b in zip(tr.state_tensors(), tr2.state_tensors()):
        assert torch.equal(a.detach(), b.detach())
    # the JAX package writes, the port reads
    s["jtr"].save()
    tr3 = _port(s, "torch_other", from_jax=False)
    tr3.save_path = s["jtr"].save_path
    tr3.load()
    np.testing.assert_array_equal(tr3.encoder_idx.detach().numpy(), s["enc"])
    got = Predictor(D3STNConfig(**KW), None, tr3.encoder_idx.detach().numpy(),
                    tr3.decoder_idx.detach().numpy(), s["adj"], s["sc"], batch_size=B,
                    device="cpu")
    got.model.load_state_dict(tr3.model.state_dict())
    want = np.asarray(JaxPredictor.from_checkpoint(jcfg, s["jtr"].save_path, s["adj"], s["sc"],
                                                   batch_size=B)(windows))
    assert _norm_err(got(windows), want) <= 1e-4
