"""The port's bfloat16 serving path against the JAX package's, on the CPU.

The JAX side runs its TPU kernels in interpret mode (``use_pallas=True,
interpret=True``, as ``tests/ops/test_gcn_pallas.py`` runs bfloat16) with x64
off, so every bfloat16 result here is compared with what the TPU kernels
compute. Inputs are made with numpy from fixed seeds.

Two measures (``paddlexde_tpu_torch.ops.compare.bf16_errors``):

- a bfloat16 result (the kernels' plain versions, the GCN sublayer, the
  dense layers, SiLU) must lie within one bfloat16 ulp at the top binade of
  the JAX result (2^-8 to 2^-7 of its maximum) on at most 1% of elements.
  Where the rounding points are the same, two results differ only where a
  float32 sum taken in another order lands on the other side of a bfloat16
  rounding boundary;
- the whole model and the Predictor return float32 after many bfloat16
  roundings, and one boundary crossed early moves the output by up to a few
  1e-3 (a bfloat16 ulp carried through the residual stream). Their error is
  held against the JAX package's own two bfloat16 routes on the same
  parameters: the Pallas route (the TPU kernels) is the reference, and the
  port must be closer to it than the XLA route is, by at least half on the
  mean error and by no less on the maximum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlexde_tpu.models.d3stn import D3STN as JaxD3STN
from paddlexde_tpu.models.d3stn import D3STNConfig as JaxConfig
from paddlexde_tpu.models.d3stn import Predictor as JaxPredictor
from paddlexde_tpu.models.d3stn import model as jax_model
from paddlexde_tpu.ops import attn_pallas, gcn_pallas
from paddlexde_tpu_torch.models.d3stn import (
    D3STN,
    D3STNConfig,
    Predictor,
    Trainer,
    load_flax_params,
    norm_adj_matrix,
)
from paddlexde_tpu_torch.models.d3stn import model as port_model
from paddlexde_tpu_torch.ops import attn, gcn
from paddlexde_tpu_torch.ops.compare import bf16_errors


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs 6 workers on 8 cores: torch's default of one compute
    thread per core in each worker (spinning between the tiny ops here)
    would take cores from the JAX tests beside it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _f32_jax():
    """The TPU kernels in interpret mode compute in float32 and bfloat16
    (as their own tests run them); restore the suite's x64 setting
    afterwards."""
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", before)


def _bf16_close(got, want):
    """``got`` (torch) within one bfloat16 ulp of ``want`` (JAX) at the top
    binade, on at most 1% of elements; returns the measures."""
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert str(got.dtype) == "torch.bfloat16" and tuple(got.shape) == want.shape
    err, ulp, share = bf16_errors(got, torch.tensor(want))
    assert err <= ulp and share <= 0.01, (err, ulp, share)
    return err, share


# K2: the plain bfloat16 version against _fwd_kernel in interpret mode, x in
# float32 (what D3STN passes) and in bfloat16. Measured: bit for bit but
# (2, 6, 3, 32) with x float32 (0.09% of elements one ulp apart, 7.1e-5),
# (2, 17, 12, 64) with x bfloat16 (0.01%, 2.0e-5) and (1, 70, 4, 128) (0.003%;
# 1.8e-4 with x float32, 5.7e-3 = one ulp at the top binade with x bfloat16)
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 6, 3, 32), (2, 17, 12, 64), (1, 70, 4, 128)])
def test_gcn_plain_matches_tpu_kernel(shape, x_dtype):
    rng = np.random.RandomState(sum(shape))
    x = rng.randn(*shape).astype(np.float32)
    gate = (0.5 * rng.rand(shape[1], shape[1])).astype(np.float32)
    scale2 = shape[-1] ** -0.5
    jx, tx = jnp.asarray(x), torch.tensor(x)
    if x_dtype == "bfloat16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    want = gcn_pallas.gcn_spatial_mix(jx, jnp.asarray(gate), scale2, "bfloat16", True, True, False)
    got = gcn.gcn_spatial_mix(tx, torch.tensor(gate), scale2, "bfloat16")
    _bf16_close(got, want)


FLAGS = {
    "encoder_self": (False, False, False),
    "decoder_masked_self": (True, True, True),
    "decoder_source": (True, False, False),
}


# K4: the plain bfloat16 version against _fwd_kernel in interpret mode.
# Measured: bit for bit but the masked flag set at 4 heads (0.03% of
# elements one ulp apart, 1.1e-4)
@pytest.mark.parametrize("heads", [2, 4])
@pytest.mark.parametrize("name", sorted(FLAGS))
def test_attention_plain_matches_tpu_kernel(name, heads):
    rng = np.random.RandomState(10 + heads)
    d, ks = 32, 3
    bound = np.sqrt(6.0 / (2 * ks * d))
    arrays = [rng.randn(2, 5, 12, d).astype(np.float32) for _ in range(3)]
    for _ in range(4):
        arrays.append(rng.uniform(-bound, bound, (ks, d, d)).astype(np.float32))
        arrays.append((0.1 * rng.randn(d)).astype(np.float32))
    flags = FLAGS[name]
    want = attn_pallas.fused_temporal_attention(*[jnp.asarray(a) for a in arrays], *flags, heads,
                                                "bfloat16", True, True, False)
    got = attn.fused_temporal_attention(*[torch.tensor(a) for a in arrays], *flags, heads,
                                        "bfloat16")
    _bf16_close(got, want)


def _parent_conv(x, w, b, causal):
    """The port's bfloat16 conv before the repair: each tap rounded to
    bfloat16 and the taps summed in bfloat16 (as ``_tconv_ref``)."""
    k, t = w.shape[0], x.shape[-2]
    pad = (k - 1, 0) if causal else ((k - 1) // 2, (k - 1) // 2)
    xp = torch.nn.functional.pad(x.to(torch.bfloat16), (0, 0, pad[0], pad[1]))
    w = w.to(torch.bfloat16)
    return sum(torch.einsum("...td,df->...tf", xp[..., j : j + t, :], w[j])
               for j in range(k)) + b.to(torch.bfloat16)


def _parent_attention(mq, mk, vs, wq, bq, wk, bk, wv, bv, wo, bo, causal_q, causal_kv, is_mask,
                      heads):
    """The port's bfloat16 attention before the repair (bfloat16 scores)."""
    q, k, v = (_parent_conv(mq, wq, bq, causal_q), _parent_conv(mk, wk, bk, causal_kv),
               _parent_conv(vs, wv, bv, causal_kv))
    b, n, t, d = q.shape
    hd = d // heads
    s = torch.einsum("bnqhd,bnkhd->bnhqk", q.reshape(b, n, t, heads, hd),
                     k.reshape(b, n, t, heads, hd)).float() / np.sqrt(hd)
    if is_mask:
        s = s + torch.triu(torch.full((t, t), torch.finfo(torch.float32).min), diagonal=1)
    x = torch.einsum("bnhqk,bnkhd->bnqhd", torch.softmax(s, -1).to(torch.bfloat16),
                     v.reshape(b, n, t, heads, hd)).reshape(b, n, t, d)
    return _parent_conv(x, wo, bo, False)


def test_the_measure_catches_the_parent_rounding_points():
    """The bfloat16 measure tells the repaired plain versions from the
    port's earlier ones (ROADMAP.md section 3): the attention summing its
    taps in bfloat16 and the GCN taking bfloat16 scores of a bfloat16 x
    differ from the TPU kernels on 4% to 72% of elements (measured: the
    attention inputs above, 66% to 72%; the GCN shapes above, 3.7% to
    18%)."""
    rng = np.random.RandomState(12)
    d, ks = 32, 3
    bound = np.sqrt(6.0 / (2 * ks * d))
    arrays = [rng.randn(2, 5, 12, d).astype(np.float32) for _ in range(3)]
    for _ in range(4):
        arrays.append(rng.uniform(-bound, bound, (ks, d, d)).astype(np.float32))
        arrays.append((0.1 * rng.randn(d)).astype(np.float32))
    want = attn_pallas.fused_temporal_attention(*[jnp.asarray(a) for a in arrays], *FLAGS[
        "encoder_self"], 2, "bfloat16", True, True, False)
    got = _parent_attention(*[torch.tensor(a) for a in arrays], *FLAGS["encoder_self"], 2)
    assert bf16_errors(got, torch.tensor(np.asarray(want.astype(jnp.float32))))[2] > 0.5
    shape = (1, 70, 4, 128)
    rng = np.random.RandomState(sum(shape))
    x = rng.randn(*shape).astype(np.float32)
    gate = (0.5 * rng.rand(shape[1], shape[1])).astype(np.float32)
    want = gcn_pallas.gcn_spatial_mix(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(gate),
                                      shape[-1] ** -0.5, "bfloat16", True, True, False)
    xb = torch.tensor(x).to(torch.bfloat16)
    score = torch.softmax((torch.einsum("bntd,bmtd->btnm", xb, xb) / np.sqrt(128)).float(), -1)
    got = torch.einsum("btnm,bmtd->bntd", (score * shape[-1] ** -0.5).to(torch.bfloat16)
                       * torch.tensor(gate).to(torch.bfloat16), xb)
    assert bf16_errors(got, torch.tensor(np.asarray(want.astype(jnp.float32))))[2] > 0.03


def test_silu_and_dense_round_as_flax():
    """``jax.nn.silu`` on bfloat16 rounds after each of its operations;
    flax ``nn.Dense(dtype=bfloat16)`` rounds the product, then adds the
    rounded bias. The port's forms give the same bits."""
    import flax.linen as nn

    rng = np.random.RandomState(0)
    x = (3 * rng.randn(20000)).astype(np.float32)
    want = jax.nn.silu(jnp.asarray(x).astype(jnp.bfloat16))
    got = port_model._silu_bf16(torch.tensor(x).to(torch.bfloat16))
    assert np.array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    for d_in, bias in ((1, True), (16, False)):
        x = rng.randn(500, d_in).astype(np.float32)
        w = (0.3 * rng.randn(d_in, 8)).astype(np.float32)
        b = (0.1 * rng.randn(8)).astype(np.float32)
        params = {"kernel": jnp.asarray(w), **({"bias": jnp.asarray(b)} if bias else {})}
        want = nn.Dense(8, use_bias=bias, dtype=jnp.bfloat16).apply({"params": params},
                                                                   jnp.asarray(x))
        layer = torch.nn.Linear(d_in, 8, bias=bias)
        with torch.no_grad():
            layer.weight.copy_(torch.tensor(w.T))
            if bias:
                layer.bias.copy_(torch.tensor(b))
            got = port_model._dense(torch.tensor(x), layer, True)
        assert np.array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


N = 10
KW = dict(num_nodes=N, his_len=64, tgt_len=12, encoder_num_layers=1, decoder_num_layers=1,
          d_model=16, d_proj=8, d_sect=4, d_adaptive=0, head=2, top_k=3,
          compute_dtype="bfloat16")


def _graph(seed):
    rng = np.random.RandomState(seed)
    adj = (rng.rand(N, N) < 0.3).astype(np.float32)
    adj = np.maximum(adj, adj.T)
    return adj, rng.rand(N, N).astype(np.float32)


def _history(rng, b, t_len):
    x = rng.randn(b, N, t_len, 3).astype(np.float32)
    x[..., 1] = rng.randint(0, 7, (b, N, t_len)) + rng.rand(b, N, t_len) * 0.9
    x[..., 2] = rng.randint(0, 288, (b, N, t_len)) + rng.rand(b, N, t_len) * 0.9
    return x


def _jax_model(route, adj, sc):
    cfg = JaxConfig(**KW, attn_impl=route, gcn_impl=route)
    return JaxD3STN(cfg, jnp.asarray(adj), jnp.asarray(sc))


def _closer_than_the_xla_route(got, pallas, xla):
    """The port against the Pallas route, no further from it than the XLA
    route is (max), and at most half as far on the mean."""
    scale = np.abs(pallas).max()
    err = np.abs(got - pallas) / scale
    ref = np.abs(xla - pallas) / scale
    assert err.max() <= ref.max(), (err.max(), ref.max())
    assert err.mean() <= 0.5 * ref.mean(), (err.mean(), ref.mean())


def test_mix_uses_the_bf16_matrix():
    """The top-k mix of a bfloat16 model: the matrix rounded to bfloat16,
    the arithmetic in float32, as the JAX model's einsum promotes it."""
    adj, sc = _graph(0)
    sc_n = norm_adj_matrix(sc).astype(np.float32)
    block = D3STN(D3STNConfig(**KW), norm_adj_matrix(adj), sc_n,
                  device="cpu").enc_0.self_attn
    x = np.random.RandomState(1).randn(2, N, 12, 16).astype(np.float32)
    mix = jax_model._topk_mix_matrix(jnp.asarray(sc_n), KW["top_k"]).astype(jnp.bfloat16)
    want = np.asarray(jnp.einsum("nm,bmt...->bnt...", mix, jnp.asarray(x)))
    got = block._mix(torch.tensor(x))
    assert got.dtype == torch.float32
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() / scale <= 1e-6
    unrounded = torch.einsum("nm,bmtd->bntd", block.mix_matrix, torch.tensor(x))
    assert np.abs(unrounded.numpy() - want).max() / scale > 1e-4


def test_d3stn_matches_the_pallas_route():
    """The port's bfloat16 D3STN (plain versions, CPU) against the JAX model
    on the TPU kernels (interpret mode), on the same parameters: each GCN
    sublayer and the two input dense layers on the JAX model's own inputs
    (captured) to the bfloat16 measure, and the whole model against the XLA
    route's distance. Measured: the GCN sublayers and the dense layers bit
    for bit; the model within 2.3e-7 (mean 3.5e-8) of the largest output,
    no rounding boundary crossed, where the XLA route is 5.8e-3 (mean
    1.1e-3) away. At other seeds of this size the port crossed a boundary
    and measured up to 4.9e-3, the XLA route up to 9.0e-3."""
    adj, sc = _graph(0)
    adj_n, sc_n = norm_adj_matrix(adj).astype(np.float32), norm_adj_matrix(sc).astype(np.float32)
    rng = np.random.RandomState(0)
    src, tgt = _history(rng, 3, 12), _history(rng, 3, 12)
    xla = _jax_model("xla", adj_n, sc_n)
    params = jax.tree.map(np.asarray, xla.init(jax.random.key(0), jnp.asarray(src),
                                               jnp.asarray(tgt))["params"])
    want, state = _jax_model("pallas", adj_n, sc_n).apply(
        {"params": params}, jnp.asarray(src), jnp.asarray(tgt), capture_intermediates=True,
        mutable=["intermediates"])
    inter = state["intermediates"]
    ref = xla.apply({"params": params}, jnp.asarray(src), jnp.asarray(tgt))

    port = D3STN(D3STNConfig(**KW), adj_n, sc_n, device="cpu").eval()
    load_flax_params(port, params)
    with torch.no_grad():
        got = port(torch.tensor(src), torch.tensor(tgt))
        for layer, sub in (("enc_0", "sub1"), ("dec_0", "sub2")):
            h = torch.tensor(np.asarray(inter[layer][sub]["LayerNorm_0"]["__call__"][0]))
            _bf16_close(getattr(port, layer).gcn(h), inter[layer]["gcn"]["__call__"][0])
        for name, x in (("encoder_dense", src), ("decoder_dense", tgt)):
            _bf16_close(port_model._dense(torch.tensor(x[..., :1]), getattr(port, name), True),
                        inter[name]["__call__"][0])
    assert got.dtype == torch.float32 and got.shape == (3, N, 12, 1)
    _closer_than_the_xla_route(got.numpy().astype(np.float64), np.asarray(want, np.float64),
                               np.asarray(ref, np.float64))


def test_predictor_matches_the_pallas_route():
    """The port's bfloat16 Predictor (CPU) against the JAX Predictor on the
    TPU kernels (interpret mode), same parameters and lags, a ragged batch:
    float32 history in, float32 forecast out, closer to the Pallas route
    than the XLA route is. Measured: max 2.4e-3 and mean 3.5e-4 of the
    largest forecast; the XLA route 3.8e-3 and 7.7e-4."""
    rng = np.random.RandomState(0)
    adj, sc = _graph(0)
    xla_cfg = JaxConfig(**KW, attn_impl="xla", gcn_impl="xla")
    model = JaxD3STN(xla_cfg, jnp.asarray(norm_adj_matrix(adj).astype(np.float32)),
                     jnp.asarray(norm_adj_matrix(sc).astype(np.float32)))
    x = jnp.zeros((2, N, 12, 3), jnp.float32)
    params = jax.tree.map(np.asarray, model.init(jax.random.key(1), x, x)["params"])
    his = KW["his_len"]
    enc = np.sort(rng.rand(12) * (his - 1)).astype(np.float32)
    dec = (his - 1 - 1.5 * rng.rand(12)).astype(np.float32)
    windows = _history(rng, 7, his)
    pallas_cfg = JaxConfig(**KW, attn_impl="pallas", gcn_impl="pallas")
    want = np.asarray(JaxPredictor(pallas_cfg, params, enc, dec, adj, sc, batch_size=4)(windows))
    ref = np.asarray(JaxPredictor(xla_cfg, params, enc, dec, adj, sc, batch_size=4)(windows))
    got = Predictor(D3STNConfig(**KW), params, enc, dec, adj, sc, batch_size=4,
                    device="cpu")(windows)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (7, N, 12)
    _closer_than_the_xla_route(got.astype(np.float64), want.astype(np.float64),
                               ref.astype(np.float64))


def test_trainer_takes_a_bf16_step(tmp_path):
    """A bfloat16 Trainer on the CPU takes a step: finite loss, parameters,
    moments and lags still float32 and moved; dropout > 0 still raises in
    training."""
    rng = np.random.RandomState(0)
    data = rng.rand(300, N, 3).astype(np.float32)
    data[..., 1] = np.arange(300)[:, None] // 288 % 7
    data[..., 2] = np.arange(300)[:, None] % 288
    adj, sc = _graph(0)
    cfg = D3STNConfig(**KW, save_dir=str(tmp_path), dataset_name="SYNTH")
    tr = Trainer(cfg, data=data, adj_matrix=adj, sc_matrix=sc, device="cpu")
    before = [t.detach().clone() for t in tr.state_tensors()]
    starts = next(tr.train_dataset.batch_starts(2))
    loss, align = tr.train_step_idx(starts, 0.5, 1e-3, 1e-2)
    assert np.isfinite(loss.item()) and np.isfinite(align.item())
    assert int(tr.opt_state["count"]) == 1
    assert all(t.dtype == torch.float32 for t in tr.state_tensors())
    assert all(v.dtype == torch.float32 for k, v in tr.opt_state.items() if k != "count")
    assert any(not torch.equal(a, b.detach()) for a, b in zip(before, tr.state_tensors()))
    dropout = Trainer(D3STNConfig(**KW, save_dir=str(tmp_path / "d"), dataset_name="SYNTH",
                                  dropout=0.1), data=data, adj_matrix=adj, sc_matrix=sc,
                      device="cpu")
    with pytest.raises(NotImplementedError, match="dropout"):
        dropout.train_step_idx(starts, 0.5, 1e-3, 1e-2)


def test_config_takes_bf16_and_refuses_other_dtypes():
    assert D3STNConfig(compute_dtype="bfloat16").compute_dtype == "bfloat16"
    with pytest.raises(ValueError, match="compute_dtype"):
        D3STNConfig(compute_dtype="float16")
