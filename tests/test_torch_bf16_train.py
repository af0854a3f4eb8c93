"""The port's bfloat16 training path against the JAX package's, on the CPU.

The JAX side runs its TPU kernels in interpret mode (the backward kernels
``_call_bwd`` and ``_pallas_bwd`` with ``dtype_name="bfloat16"``) with x64
off, as ``tests/test_torch_bf16.py`` does for serving; inputs come from
numpy seeds. Where the TPU ``_bwd_kernel`` and autograd of ``_ref_impl``
round at different points, the port follows ``_bwd_kernel``. Each of the
four repairs of the bfloat16 backward (ROADMAP.md section 3) is held here:

1. the plain attention backward against ``_call_bwd`` (``attn.bwd_errors``,
   the largest of the 11 normalised errors), with a control: autograd
   through the plain forward, the parent's route, must fail the same limit;
2. the GCN gradient against ``_pallas_bwd``;
3. SiLU's gradient against ``jax.vjp(jax.nn.silu)``;
4. the dense layer against ``jax.vjp`` of flax ``nn.Dense(dtype=bfloat16)``,
   and its backward on the card's branch (meta tensors);

and the whole step: the port's bfloat16 ``Trainer.loss_fn`` and gradients
against the JAX Trainer's ``_loss_fn`` on the TPU kernels, no further from
it than the JAX package's own XLA route.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlexde_tpu.models.d3stn import D3STN as JaxD3STN
from paddlexde_tpu.models.d3stn import D3STNConfig as JaxConfig
from paddlexde_tpu.models.d3stn import Trainer as JaxTrainer
from paddlexde_tpu.models.d3stn import synthetic_traffic_npz
from paddlexde_tpu.ops import attn_pallas, gcn_pallas
from paddlexde_tpu_torch.models.d3stn import D3STNConfig, Trainer
from paddlexde_tpu_torch.models.d3stn import model as port_model
from paddlexde_tpu_torch.models.d3stn.weights import _flax_to_state_dict, load_flax_params
from paddlexde_tpu_torch.ops import attn, gcn
from paddlexde_tpu_torch.ops.compare import bf16_errors


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch compute thread per worker (the suite runs 6 workers on 8
    cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _f32_jax():
    """The TPU kernels in interpret mode compute in float32 and bfloat16;
    restore the suite's x64 setting afterwards."""
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", before)


def _bf16(rng, *shape):
    """A bfloat16 normal sample as (JAX array, torch tensor) of the same bits."""
    a = jnp.asarray(rng.randn(*shape).astype(np.float32)).astype(jnp.bfloat16)
    return a, torch.tensor(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)


FLAGS = {
    "encoder_self": (False, False, False),
    "decoder_masked_self": (True, True, True),
    "decoder_source": (True, False, False),
}
# Fault 1: measured 1.3e-4 at most (the encoder flag set at 2 heads; the
# other five cases 1.4e-7 to 5.5e-6), where a float32 sum in another order
# puts a rounded dq, dk or dv one bfloat16 ulp away; the parent's route
# measured 3.3e-3 to 5.3e-3
ATTN_BWD_TOL = 5e-4


def _attention_case(heads):
    seed = 10 + heads
    rng = np.random.RandomState(seed)
    d, ks = 32, 3
    bound = np.sqrt(6.0 / (2 * ks * d))
    arrays = [rng.randn(2, 5, 12, d).astype(np.float32) for _ in range(3)]
    for _ in range(4):
        arrays.append(rng.uniform(-bound, bound, (ks, d, d)).astype(np.float32))
        arrays.append((0.1 * rng.randn(d)).astype(np.float32))
    g_jax, g = _bf16(rng, 2, 5, 12, d)
    return arrays, g_jax, g


def _tpu_attention_bwd(arrays, g_jax, flags, heads):
    statics = dict(causal_q=flags[0], causal_kv=flags[1], is_mask=flags[2], heads=heads,
                   dtype_name="bfloat16")
    outs = attn_pallas._call_bwd(*[jnp.asarray(a) for a in arrays[:3]],
                                 [jnp.asarray(a) for a in arrays[3:]], g_jax, statics, True)
    return [np.asarray(o.astype(jnp.float32)) for o in outs]


@pytest.mark.parametrize("heads", [2, 4])
@pytest.mark.parametrize("name", sorted(FLAGS))
def test_attention_bwd_plain_matches_tpu_kernel(name, heads):
    """The plain bfloat16 backward, called directly and through autograd of
    ``fused_temporal_attention``, against the interpret-mode ``_call_bwd``;
    autograd through the plain forward (the parent's route) fails the limit."""
    arrays, g_jax, g = _attention_case(heads)
    flags = FLAGS[name]
    want = _tpu_attention_bwd(arrays, g_jax, flags, heads)
    got = attn.fused_temporal_attention_bwd_plain(*[torch.tensor(a) for a in arrays], g, *flags,
                                                  heads, "bfloat16")
    assert got[0].dtype == torch.float32 and got[3].dtype == torch.float32
    assert max(attn.bwd_errors(got, want)) <= ATTN_BWD_TOL
    leaves = [torch.tensor(a).requires_grad_() for a in arrays]
    y = attn.fused_temporal_attention(*leaves, *flags, heads, "bfloat16")
    assert y.dtype == torch.bfloat16
    routed = torch.autograd.grad(y, leaves, g)
    assert all(torch.equal(a, b) for a, b in zip(routed, got))
    leaves = [torch.tensor(a).requires_grad_() for a in arrays]
    parent = torch.autograd.grad(attn.fused_temporal_attention_plain(*leaves, *flags, heads,
                                                                     "bfloat16"), leaves, g)
    assert max(attn.bwd_errors(parent, want)) > 2 * ATTN_BWD_TOL


def test_attention_bwd_plain_takes_bf16_inputs_and_adds_aliased_gradients():
    """bfloat16 activations give their gradients in bfloat16 (the TPU kernel
    writes them in their inputs' dtypes); with ``mk is mq`` autograd adds the
    two input gradients."""
    arrays, g_jax, g = _attention_case(2)
    flags = FLAGS["encoder_self"]
    acts = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays[:3]]
    statics = dict(causal_q=False, causal_kv=False, is_mask=False, heads=2,
                   dtype_name="bfloat16")
    want = attn_pallas._call_bwd(*acts, [jnp.asarray(a) for a in arrays[3:]], g_jax, statics,
                                 True)
    tacts = [torch.tensor(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16) for a in acts]
    got = attn.fused_temporal_attention_bwd_plain(*tacts, *[torch.tensor(a) for a in arrays[3:]],
                                                  g, *flags, 2, "bfloat16")
    want = [np.asarray(w.astype(jnp.float32)) for w in want]
    assert all(a.dtype == torch.bfloat16 for a in got[:3])
    # the input gradients rounded to bfloat16: within one ulp at the top
    # binade on at most 1% of elements (ops/compare.py; measured one ulp on
    # up to 0.34%); the weight gradients as above
    for a, w in zip(got[:3], want[:3]):
        err, ulp, share = bf16_errors(a, torch.tensor(w))
        assert err <= ulp and share <= 0.01, (err, ulp, share)
    assert max(attn.bwd_errors(got, want)[3:]) <= ATTN_BWD_TOL
    x = torch.tensor(arrays[0]).requires_grad_()
    weights = [torch.tensor(a) for a in arrays[3:]]
    dx, = torch.autograd.grad(attn.fused_temporal_attention(x, x, x, *weights, *flags, 2,
                                                            "bfloat16"), [x], g)
    parts = attn.fused_temporal_attention_bwd_plain(x.detach(), x.detach(), x.detach(), *weights,
                                                    g, *flags, 2, "bfloat16")
    assert torch.allclose(dx, parts[0] + parts[1] + parts[2], rtol=1e-6, atol=1e-7)


# Fault 2: measured 6.8e-7 (dx) and 3.8e-7 (dgate), float32 sums in other
# orders; autograd through the plain bfloat16 forward (the parent) 3.7e-3
# and 3.3e-3
GCN_BWD_TOL = 1e-5


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_gcn_bwd_matches_tpu_kernel(x_dtype):
    rng = np.random.RandomState(203)
    x = rng.randn(2, 24, 4, 64).astype(np.float32)
    gate = (0.5 * rng.rand(24, 24)).astype(np.float32)
    g_jax, g = _bf16(rng, 2, 24, 4, 64)
    scale2 = 64 ** -0.5
    jx, tx = jnp.asarray(x), torch.tensor(x)
    if x_dtype == "bfloat16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    dx, dgate = gcn_pallas._pallas_bwd(jx, jnp.asarray(gate), g_jax, 1 / 8, scale2, "bfloat16",
                                       True)
    want = [np.asarray(a.astype(jnp.float32), np.float64) for a in (dx, dgate)]
    tx.requires_grad_()
    tgate = torch.tensor(gate).requires_grad_()
    y = gcn.gcn_spatial_mix(tx, tgate, scale2, "bfloat16")
    got = torch.autograd.grad(y, [tx, tgate], g)
    assert got[0].dtype == tx.dtype and got[1].dtype == torch.float32

    def err(a, w):
        return np.abs(a.detach().double().numpy() - w).max() / np.abs(w).max()

    assert max(err(a, w) for a, w in zip(got, want)) <= GCN_BWD_TOL
    y = gcn.gcn_spatial_mix_plain(tx, tgate, scale2, "bfloat16")
    parent = torch.autograd.grad(y, [tx, tgate], g)
    assert max(err(a, w) for a, w in zip(parent, want)) > 100 * GCN_BWD_TOL


def test_silu_gradient_rounds_as_jax():
    """Fault 3: JAX's ``logistic`` rule with every product rounded, bit for
    bit; autograd of the rounded forward (the parent) measured 1.34e-2
    against a one-ulp limit of 4.46e-3, on 46% of elements."""
    rng = np.random.RandomState(0)
    x_jax, x = _bf16(rng, 4096)
    x_jax, x = 3 * x_jax, 3 * x
    g_jax, g = _bf16(rng, 4096)
    _, vjp = jax.vjp(jax.nn.silu, x_jax)
    want = torch.tensor(np.asarray(vjp(g_jax)[0].astype(jnp.float32)))
    x.requires_grad_()
    got, = torch.autograd.grad(port_model._silu_bf16(x), x, g)
    assert got.dtype == torch.bfloat16 and torch.equal(got.float(), want)
    parent, = torch.autograd.grad(x * (1 / (1 + torch.exp(-x))), x, g)
    err, ulp, _ = bf16_errors(parent, want)
    assert err > ulp


def test_dense_gradient_rounds_as_flax():
    """Fault 4: dx and dW bit for bit against ``jax.vjp`` of flax
    ``nn.Dense(dtype=bfloat16)``; db, the float32 sum of g rounded once,
    against the float64 sum rounded to bfloat16. (JAX on the CPU sums db in
    bfloat16, XLA's CPU backend: 7.0e-3 from the exact sum where the
    rounded exact sum is 1.65e-3 away, so flax's db is not the reference.)"""
    import flax.linen as nn

    rng = np.random.RandomState(1)
    x = rng.randn(512, 128).astype(np.float32)
    w = (0.1 * rng.randn(128, 64)).astype(np.float32)
    b = (0.1 * rng.randn(64)).astype(np.float32)
    g_jax, g = _bf16(rng, 512, 64)
    params = {"params": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}}
    _, vjp = jax.vjp(lambda p, x_: nn.Dense(64, dtype=jnp.bfloat16).apply(p, x_), params,
                     jnp.asarray(x))
    dparams, dx = vjp(g_jax)
    layer = torch.nn.Linear(128, 64)
    with torch.no_grad():
        layer.weight.copy_(torch.tensor(w.T))
        layer.bias.copy_(torch.tensor(b))
    tx = torch.tensor(x).requires_grad_()
    got = torch.autograd.grad(port_model._dense(tx, layer, True), [tx, layer.weight, layer.bias], g)
    assert all(a.dtype == torch.float32 for a in got)
    assert np.array_equal(got[0].numpy(), np.asarray(dx))
    assert np.array_equal(got[1].numpy().T, np.asarray(dparams["params"]["kernel"]))
    exact = torch.tensor(g.double().sum(dim=0).numpy()).to(torch.bfloat16).float()
    assert torch.equal(got[2], exact)


def test_dense_backward_runs_on_the_cards_branch():
    """The card's branch (cuBLAS's bfloat16 GEMM into float32, which has no
    derivative: ``RuntimeError: derivative for aten::mm is not
    implemented``) differentiates through the layer's own backward; on meta
    tensors, which take that branch, the gradients have the parameters'
    shapes and dtypes."""
    layer = torch.nn.Linear(16, 8).to("meta")
    x = torch.empty(3, 5, 16, device="meta", requires_grad=True)
    y = port_model._dense(x, layer, True)
    assert y.shape == (3, 5, 8) and y.dtype == torch.bfloat16
    grads = torch.autograd.grad(y.float().sum(), [x, layer.weight, layer.bias])
    assert [tuple(a.shape) for a in grads] == [(3, 5, 16), (8, 16), (8,)]
    assert all(a.dtype == torch.float32 for a in grads)


N, HIS, B = 10, 64, 4
KW = dict(dataset_name="SYNTH", num_nodes=N, his_len=HIS, tgt_len=12, encoder_num_layers=1,
          decoder_num_layers=1, d_model=16, d_proj=8, d_sect=4, d_adaptive=0, head=2, top_k=3,
          attention="Corr", batch_size=B, train_epochs=1, finetune_epochs=0, warmup_step=1,
          decay_step=2, patience=5, loss="mae", kl_loss_weight=0.01, compute_dtype="bfloat16")
KL = 0.37
# the dense layers' bias gradients, which JAX on the CPU sums in bfloat16
# (test_dense_gradient_rounds_as_flax): measured 1.1e-1 and 7.0e-2 from the
# Pallas route, against the XLA route's 1.5e-2 and 2.2e-2
JAX_CPU_BF16_SUMS = ("encoder_dense.bias", "decoder_dense.bias")
# where the two JAX routes agree to float32 noise (the generator's and the
# last LayerNorm's biases, 3e-7 to 9e-7 apart), the float32 Trainer test's
# limit (tests/test_torch_trainer.py) holds instead
F32_LIMIT = 1e-4


def test_whole_step_matches_the_pallas_route(tmp_path):
    """The port's bfloat16 ``Trainer.loss_fn`` (plain versions, CPU) against
    the JAX Trainer's ``_loss_fn`` on the TPU kernels (interpret mode), on
    the same parameters, lags and window: the loss and each gradient leaf no
    further from the Pallas route than the XLA route is (normalised by the
    leaf's largest Pallas value, the key-conv biases by their module's other
    conv biases), on the max and by half on the mean. Measured: the loss
    6.0e-8 from the Pallas route (XLA 4.7e-4); the gradients at most 1.0e-4
    (the decoder lags; the parameters 2.5e-5) where the XLA route lies
    2.1e-3 to 2.7e-1 away, but for the two leaves of F32_LIMIT."""
    data = synthetic_traffic_npz(num_nodes=N, seq_len=288 * 2)
    rng = np.random.RandomState(0)
    adj = (rng.rand(N, N) < 0.3).astype(np.float32)
    adj = np.maximum(adj, adj.T)
    sc = rng.rand(N, N).astype(np.float32)
    enc = (np.arange(HIS - 12, HIS) - 0.5 - 3 * rng.rand(12)).astype(np.float32)
    dec = (HIS - 1 - 2 * rng.rand(12)).astype(np.float32)
    init = JaxD3STN.init
    routes, inits = {}, []

    def init_once(self, key, *xs):
        # one jitted init (tests/test_torch_trainer.py), shared by the two
        # routes' trainers: the XLA trainer's parameters are replaced by the
        # Pallas trainer's below, so it needs only the tree
        if not inits:
            inits.append(jax.jit(lambda k, *a: init(self, k, *a))(key, *xs))
        return inits[0]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxD3STN, "init", init_once)
        for route in ("pallas", "xla"):
            routes[route] = JaxTrainer(JaxConfig(**KW, attn_impl=route, gcn_impl=route,
                                                 save_dir=str(tmp_path / route)),
                                       data=data, adj_matrix=adj, sc_matrix=sc)
    jtr = routes["pallas"]
    ds = jtr.train_dataset
    s_b = next(ds.batch_starts(B, shuffle=True, seed=3))
    src = np.stack([ds.data[:, s : s + HIS] for s in s_b])
    tgt = np.stack([ds.data[:, s + HIS : s + HIS + 12] for s in s_b])
    params = jax.tree.map(np.asarray, jtr.params)
    want = {}
    for route, t in routes.items():
        t.params = jax.tree.map(jnp.asarray, params)
        t.encoder_idx, t.decoder_idx = jnp.asarray(enc), jnp.asarray(dec)
        fn = jax.jit(jax.value_and_grad(t._loss_fn, has_aux=True))
        (total, _), grads = fn(t.state, jnp.asarray(src), jnp.asarray(tgt),
                               jnp.asarray(KL, jnp.float32))
        leaves = _flax_to_state_dict(jax.tree.map(np.asarray, grads["net"]))
        leaves["enc_idx"], leaves["dec_idx"] = grads["enc_idx"], grads["dec_idx"]
        want[route] = (float(total), {k: np.asarray(v, np.float64) for k, v in leaves.items()})

    tr = Trainer(D3STNConfig(**KW, save_dir=str(tmp_path / "torch")), data=data,
                 adj_matrix=adj, sc_matrix=sc, device="cpu")
    load_flax_params(tr.model, params)
    with torch.no_grad():
        tr.encoder_idx.copy_(torch.tensor(enc))
        tr.decoder_idx.copy_(torch.tensor(dec))
    total, _, _ = tr.loss_fn(torch.tensor(src), torch.tensor(tgt), KL)
    grads = torch.autograd.grad(total, tr.state_tensors(), materialize_grads=True)
    got = {k: g.double().numpy() for k, g in zip(tr.state_names, grads)}
    (pallas_total, pallas), (xla_total, xla) = want["pallas"], want["xla"]
    assert abs(total.item() - pallas_total) <= abs(xla_total - pallas_total)
    assert set(got) == set(pallas)
    for k in got:
        if k in JAX_CPU_BF16_SUMS:
            continue
        scale = np.abs(pallas[k]).max()
        if k.endswith("key_conv.bias"):
            prefix = k[: -len("key_conv.bias")]
            scale = max(np.abs(pallas[prefix + c + "_conv.bias"]).max()
                        for c in ("query", "value", "out"))
        err = np.abs(got[k] - pallas[k]) / scale
        ref = np.abs(xla[k] - pallas[k]) / scale
        assert err.max() <= max(ref.max(), F32_LIMIT), (k, err.max(), ref.max())
        assert err.mean() <= max(0.5 * ref.mean(), F32_LIMIT), (k, err.mean(), ref.mean())
