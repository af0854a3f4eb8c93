"""The port's dropout path against the JAX package's, on the CPU.

The JAX side runs the dropout forms of its TPU attention kernels in
interpret mode (``fused_temporal_attention_dropout`` with ``use_pallas``,
x64 off); inputs and keep masks come from numpy seeds.

- The plain attention forward and its 11 gradients with a keep mask, at
  B = 2, N = 5, T = 12, D = 32, 2 and 4 heads and D3STN's three flag sets:
  float32 within the tolerances of ``tests/ops/test_attn_dropout.py``
  (1e-5 forward, 1e-4 gradients), bfloat16 by ``ops/compare.py``'s measure
  (forward) and ``attn.bwd_errors`` within 5e-4 (gradients), with a control
  that rounds bf16(p) m instead of bf16(p m) and must fail; an all-keep
  mask gives the no-dropout function; the mask gets no gradient.
- One Trainer step of a tiny config at ``dropout=0.3`` against the JAX
  Trainer's ``_loss_fn`` with ``attn_impl="pallas"`` (interpret mode), with
  the same masks: ``jax.random.bernoulli`` (which the model's attention
  site and flax's ``nn.Dropout`` look up at call time) is replaced by a
  numpy draw whose masks the port's mask source then serves in call order.
  Float32 within ``tests/test_torch_trainer.py``'s tolerances, bfloat16 by
  ``tests/test_torch_bf16_train.py``'s rule (no further from the Pallas
  route than the JAX package's XLA route), but for the leaves whose
  gradient JAX on the CPU sums in bfloat16. The trainers share one jitted
  JAX init.
- One float32 Trainer step at SYNTH's width and depth (d_model 64, 4 heads,
  2+2 layers, top_k 4, with_adj), dropout 0.1, against the JAX Trainer's
  XLA route with the same masks (``test_synth_width_step_matches_jax``).
- The GCN's dropout form (the JAX model's XLA form, no kernel) against JAX,
  its bfloat16 gate gradient against the exact sum rounded once.
- Eval is deterministic; with the ``midpoint`` solver the model calls of one
  step receive the same masks; ``gcn_impl="pallas"`` with dropout warns.
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
from paddlexde_tpu.ops import attn_pallas
from paddlexde_tpu_torch.models.d3stn import D3STNConfig, Trainer
from paddlexde_tpu_torch.models.d3stn.model import DropoutMasks
from paddlexde_tpu_torch.models.d3stn.weights import (
    _flax_to_state_dict,
    load_flax_params,
    to_flax_params,
)
from paddlexde_tpu_torch.ops import attn
from paddlexde_tpu_torch.ops.compare import bf16_errors
from paddlexde_tpu_torch.ops.timing import attn_bwd_work, attn_work


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


FLAGS = {
    "encoder_self": (False, False, False),
    "decoder_masked_self": (True, True, True),
    "decoder_source": (True, False, False),
}
ATTN_BWD_BF16_TOL = 5e-4


def _attention_case(heads, rate=0.3):
    """mq, mk, vs, the four convs' weights, a cotangent and a pre-scaled
    keep mask [2, 5, 12, heads * 12], as numpy float32."""
    rng = np.random.RandomState(20 + heads)
    d, ks = 32, 3
    bound = np.sqrt(6.0 / (2 * ks * d))
    arrays = [rng.randn(2, 5, 12, d).astype(np.float32) for _ in range(3)]
    for _ in range(4):
        arrays.append(rng.uniform(-bound, bound, (ks, d, d)).astype(np.float32))
        arrays.append((0.1 * rng.randn(d)).astype(np.float32))
    g = rng.randn(2, 5, 12, d).astype(np.float32)
    keep = np.float32(1.0 - rate)
    mask = (rng.rand(2, 5, 12, heads * 12) < keep).astype(np.float32) / keep
    return arrays, g, mask


def _tpu_dropout(arrays, g, mask, flags, heads, dtype_name):
    """The JAX dropout block on its TPU kernels in interpret mode: the
    output and the 11 gradients for the cotangent g (in the compute dtype)."""
    dt = jnp.bfloat16 if dtype_name == "bfloat16" else jnp.float32
    fn = lambda *a: attn_pallas.fused_temporal_attention_dropout(  # noqa: E731
        *a, jnp.asarray(mask), *flags, heads, dtype_name, True, True, False)
    y, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in arrays])
    grads = vjp(jnp.asarray(g).astype(dt))
    return (np.asarray(y.astype(jnp.float32)),
            [np.asarray(a.astype(jnp.float32)) for a in grads])


def _port_dropout(arrays, g, mask, flags, heads, dtype_name):
    leaves = [torch.tensor(a).requires_grad_() for a in arrays]
    tmask = torch.tensor(mask).requires_grad_()
    y = attn.fused_temporal_attention_dropout(*leaves, tmask, *flags, heads, dtype_name)
    cot = torch.tensor(g).to(y.dtype)
    *grads, dmask = torch.autograd.grad(y, leaves + [tmask], cot, allow_unused=True)
    assert dmask is None
    return y.detach(), grads


@pytest.mark.parametrize("heads", [2, 4])
@pytest.mark.parametrize("name", sorted(FLAGS))
def test_float32_dropout_matches_tpu_kernels(name, heads):
    arrays, g, mask = _attention_case(heads)
    flags = FLAGS[name]
    want_y, want = _tpu_dropout(arrays, g, mask, flags, heads, "float32")
    y, grads = _port_dropout(arrays, g, mask, flags, heads, "float32")
    np.testing.assert_allclose(y.numpy(), want_y, rtol=1e-5, atol=1e-5)
    for a, w in zip(grads, want):
        np.testing.assert_allclose(a.numpy(), w, rtol=1e-4, atol=1e-5)


def _bf16_p_then_mask(orig):
    """``_attention_core_bf16`` whose value product takes bf16(p) m (the
    mask after the rounding) instead of bf16(p m): the control."""

    def core(q, k, v, is_mask, heads, dropout_mask=None):
        _, p = orig(q, k, v, is_mask, heads)
        b, n, t_q, d = q.shape
        vh = v.float().reshape(b, n, -1, heads, d // heads)
        p_eff = p.to(torch.bfloat16).float() * attn._head_major(dropout_mask, heads)
        x = torch.einsum("bnqhk,bnkhd->bnqhd", p_eff, vh)
        return x.to(torch.bfloat16).reshape(b, n, t_q, d), p

    return core


@pytest.mark.parametrize("heads", [2, 4])
@pytest.mark.parametrize("name", sorted(FLAGS))
def test_bfloat16_dropout_matches_tpu_kernels(name, heads, monkeypatch):
    """The forward within one bfloat16 ulp at the top binade on at most 1%
    of elements, the gradients within ATTN_BWD_BF16_TOL; the control (the
    mask after the rounding) fails one of the two."""
    arrays, g, mask = _attention_case(heads)
    flags = FLAGS[name]
    want_y, want = _tpu_dropout(arrays, g, mask, flags, heads, "bfloat16")
    y, grads = _port_dropout(arrays, g, mask, flags, heads, "bfloat16")
    assert y.dtype == torch.bfloat16
    err, ulp, share = bf16_errors(y, torch.tensor(want_y))
    assert err <= ulp and share <= 0.01, (err, ulp, share)
    assert max(attn.bwd_errors(grads, want)) <= ATTN_BWD_BF16_TOL
    monkeypatch.setattr(attn, "_attention_core_bf16",
                        _bf16_p_then_mask(attn._attention_core_bf16))
    y, grads = _port_dropout(arrays, g, mask, flags, heads, "bfloat16")
    err, ulp, share = bf16_errors(y, torch.tensor(want_y))
    fwd_ok = err <= ulp and share <= 0.01
    assert not (fwd_ok and max(attn.bwd_errors(grads, want)) <= ATTN_BWD_BF16_TOL)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_all_keep_mask_is_the_no_dropout_block(dtype_name):
    """An all-keep mask gives the no-dropout forward bit for bit, and the
    plain dropout backward the no-dropout plain backward bit for bit."""
    arrays, g, mask = _attention_case(4)
    args = [torch.tensor(a) for a in arrays]
    cot = torch.tensor(g)
    ones = torch.ones(mask.shape)
    flags = FLAGS["decoder_masked_self"]
    with torch.no_grad():
        y = attn.fused_temporal_attention_dropout(*args, ones, *flags, 4, dtype_name)
        assert torch.equal(y, attn.fused_temporal_attention(*args, *flags, 4, dtype_name))
    got = attn.fused_temporal_attention_bwd_plain(*args, cot, *flags, 4, dtype_name, ones)
    want = attn.fused_temporal_attention_bwd_plain(*args, cot, *flags, 4, dtype_name)
    assert all(torch.equal(a, w) for a, w in zip(got, want))


def test_dropout_bounds_add_the_mask():
    """The dropout forms' work adds the float32 mask's read (25.1 MB at
    PEMS08, batch 32) and its multiplies (one per weight in the forward,
    three in the backward)."""
    mask_bytes = 4 * 32 * 170 * 12 * 96
    for work in (attn_work, attn_bwd_work):
        plain, drop = work(32, 170, 12, 128, 8, 3), work(32, 170, 12, 128, 8, 3, dropout=True)
        assert drop.bytes - plain.bytes == mask_bytes
        assert drop.products == plain.products
    assert (attn_work(32, 170, 12, 128, 8, 3, dropout=True).other
            - attn_work(32, 170, 12, 128, 8, 3).other) == 32 * 170 * 8 * 144
    assert (attn_bwd_work(32, 170, 12, 128, 8, 3, dropout=True).other
            - attn_bwd_work(32, 170, 12, 128, 8, 3).other) == 3 * 32 * 170 * 8 * 144


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_gcn_dropout_form_matches_jax(dtype_name):
    """``gcn_spatial_mix_dropout`` against the JAX model's XLA form of the
    GCN with dropout on the same keep mask: the forward bit for bit in
    bfloat16 and within 1e-6 in float32, dx within 1e-5. dgate in float32
    within 1e-5; in bfloat16 it is the float64 sum over (b, t) of the
    bfloat16 products bf16(d_adj) bf16(score), rounded once (the TPU's
    float32 sum), bit for bit. (JAX on the CPU sums it in bfloat16:
    measured 6.8e-3 from that sum, normalised, so the whole-step test does
    not hold the gates to JAX's CPU value.)"""
    import math

    from jax import lax

    from paddlexde_tpu_torch.ops.gcn import gcn_spatial_mix_dropout

    rng = np.random.RandomState(0)
    b, n, t, d, keep = 4, 8, 12, 16, 0.7
    scale2 = 1 / math.sqrt(d)
    x = rng.randn(b, n, t, d).astype(np.float32)
    gate = rng.rand(n, n).astype(np.float32)
    mask = rng.rand(b, t, n, n) < keep
    g = rng.randn(b, n, t, d).astype(np.float32)
    bf16 = dtype_name == "bfloat16"
    dt = jnp.bfloat16 if bf16 else jnp.float32

    def xla_form(x_, gate_):  # paddlexde_tpu/models/d3stn/model.py, SpatialAttentionGCN
        score = jnp.einsum("bntd,bmtd->btnm", x_, x_, preferred_element_type=jnp.float32)
        score = jax.nn.softmax(score / math.sqrt(d), axis=-1)
        score = lax.select(jnp.asarray(mask), score / keep, jnp.zeros_like(score)) * scale2
        return jnp.einsum("btnm,bmtd->bntd", score.astype(dt) * gate_.astype(dt), x_.astype(dt))

    y, vjp = jax.vjp(xla_form, jnp.asarray(x), jnp.asarray(gate))
    g_jax = jnp.asarray(g).astype(dt)
    dx, dgate = (np.asarray(a, np.float64) for a in vjp(g_jax))
    tx, tgate = torch.tensor(x).requires_grad_(), torch.tensor(gate).requires_grad_()
    ty = gcn_spatial_mix_dropout(tx, tgate, scale2, torch.tensor(mask), keep, dtype_name)
    cot = torch.tensor(np.asarray(g_jax.astype(jnp.float32))).to(ty.dtype)
    tdx, tdgate = torch.autograd.grad(ty, [tx, tgate], cot)

    def err(a, w):
        return np.abs(a.detach().double().numpy() - w).max() / np.abs(w).max()

    want_y = np.asarray(y.astype(jnp.float32), np.float64)
    assert ty.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert err(tdx, dx) <= 1e-5
    if not bf16:
        assert err(ty, want_y) <= 1e-6 and err(tdgate, dgate) <= 1e-5
        return
    assert np.array_equal(ty.detach().float().numpy(), want_y)
    with torch.no_grad():
        xd = tx.double()
        score = torch.softmax(torch.einsum("bntd,bmtd->btnm", tx, tx) / math.sqrt(d), dim=-1)
        score = torch.where(torch.tensor(mask), score / torch.tensor(keep), 0.0) * scale2
        r = lambda a: a.to(torch.bfloat16).double()  # noqa: E731
        d_adj = r(torch.einsum("bntd,bmtd->btnm", cot.double(), r(xd)))
        exact = r((r(d_adj * r(score))).sum(dim=(0, 1)))
    assert torch.equal(tdgate.double(), exact)


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------

N, HIS, B = 8, 64, 4
KW = dict(dataset_name="SYNTH", num_nodes=N, his_len=HIS, tgt_len=12, encoder_num_layers=1,
          decoder_num_layers=1, d_model=16, d_proj=8, d_sect=4, d_adaptive=0, head=2, top_k=3,
          attention="Corr", batch_size=B, train_epochs=1, finetune_epochs=0, warmup_step=1,
          decay_step=2, patience=5, loss="mae", kl_loss_weight=0.01, dropout=0.3)
KL = 0.37
# D3STN's dropout sites in call order for 1 + 1 layers: the encoder's
# attention, its residual, the GCN's scores, their residual; the decoder's
# two attentions each with its residual, its GCN scores and their residual
SITES = 10
# as in tests/test_torch_bf16_train.py: the dense layers' bias gradients,
# which JAX on the CPU sums in bfloat16, and the limit where the two JAX
# routes agree to float32 noise; with dropout also the GCN gates, whose
# gradient JAX on the CPU sums in bfloat16 too
# (test_gcn_dropout_form_matches_jax; measured 7.1e-4 to 2.4e-3 from the
# Pallas route, the XLA route 5.4e-4 to 2.1e-3)
JAX_CPU_BF16_SUMS = ("encoder_dense.bias", "decoder_dense.bias", ".gcn.alpha", ".gcn.beta")
F32_LIMIT = 1e-4


class ReplayMasks(DropoutMasks):
    """Serves the given boolean masks in call order, asserting each shape."""

    def __init__(self, masks):
        super().__init__()
        self.masks, self.served = masks, 0

    def keep(self, shape, keep, device):
        mask = self.masks[self.served]
        assert tuple(shape) == mask.shape, (self.served, tuple(shape), mask.shape)
        self.served += 1
        return torch.tensor(mask, device=device)


def _recording_bernoulli(masks, seed=5, replay=None):
    """``jax.random.bernoulli`` drawing ``uniform < p`` with numpy (the
    masks appended to ``masks``), or serving ``replay`` in order, an
    attention mask asked for as [B, N, H, Tq, Tk] (the XLA route's
    ``nn.Dropout``) from the kernel's [B, N, Tq, H*Tk]."""
    rng = np.random.RandomState(seed)

    def bernoulli(key, p=0.5, shape=None, mode="low"):
        shape = tuple(shape)
        if replay is None:
            mask = rng.rand(*shape) < p
        else:
            mask = replay[len(masks)]
            if mask.shape != shape:
                b, n, h, t_q, t_k = shape
                mask = mask.reshape(b, n, t_q, h, t_k).transpose(0, 1, 3, 2, 4)
        masks.append(mask)
        return jnp.asarray(mask)

    return bernoulli


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("dropout")
    data = synthetic_traffic_npz(num_nodes=N, seq_len=288 * 2)
    rng = np.random.RandomState(0)
    adj = (rng.rand(N, N) < 0.3).astype(np.float32)
    adj = np.maximum(adj, adj.T)
    sc = rng.rand(N, N).astype(np.float32)
    enc = (np.arange(HIS - 12, HIS) - 0.5 - 3 * rng.rand(12)).astype(np.float32)
    dec = (HIS - 1 - 2 * rng.rand(12)).astype(np.float32)
    return dict(root=root, data=data, adj=adj, sc=sc, enc=enc, dec=dec, inits={})


def _jax_trainer(s, route, **kw):
    """A JAX Trainer of KW (updated by ``kw``) on the setup's data. Its
    model's initial parameters come from one jitted init per model shape
    (``s["inits"]``): flax draws float32 parameters from the config's seed
    whatever the compute dtype or the kernel route, so each trainer gets the
    tree its own init would return (the bfloat16 test's trainers overwrite
    them with the float32 Pallas trainer's anyway) without tracing and
    compiling the init again (3.6 s a trainer)."""
    init, inits = JaxD3STN.init, s["inits"]
    shape = tuple(sorted((k, v) for k, v in {**KW, **kw}.items() if k != "compute_dtype"))

    def init_once(self, key, *xs):
        if shape not in inits:  # one jitted init (tests/test_torch_trainer.py)
            inits[shape] = jax.jit(lambda k, *a: init(self, k, *a))(key, *xs)
        return inits[shape]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxD3STN, "init", init_once)
        cfg = JaxConfig(**{**KW, **kw}, attn_impl=route, gcn_impl="xla",
                        save_dir=str(s["root"] / f"jax_{route}_{kw}"))
        return JaxTrainer(cfg, data=s["data"], adj_matrix=s["adj"], sc_matrix=s["sc"])


def _jax_step(t, s, src, tgt, params, bernoulli):
    """Loss and gradient leaves of the JAX Trainer's ``_loss_fn`` with a
    dropout rng, ``jax.random.bernoulli`` replaced while it traces."""
    t.params = jax.tree.map(jnp.asarray, params)
    t.encoder_idx, t.decoder_idx = jnp.asarray(s["enc"]), jnp.asarray(s["dec"])
    fn = jax.jit(jax.value_and_grad(t._loss_fn, has_aux=True))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", bernoulli)
        (total, _), grads = fn(t.state, jnp.asarray(src), jnp.asarray(tgt),
                               jnp.asarray(KL, jnp.float32), jax.random.key(1))
    leaves = _flax_to_state_dict(jax.tree.map(np.asarray, grads["net"]))
    leaves["enc_idx"], leaves["dec_idx"] = grads["enc_idx"], grads["dec_idx"]
    return float(total), {k: np.asarray(v, np.float64) for k, v in leaves.items()}


def _port_step(s, params, masks, name, **kw):
    tr = Trainer(D3STNConfig(**{**KW, **kw}, save_dir=str(s["root"] / name)), data=s["data"],
                 adj_matrix=s["adj"], sc_matrix=s["sc"], device="cpu")
    load_flax_params(tr.model, params)
    with torch.no_grad():
        tr.encoder_idx.copy_(torch.tensor(s["enc"]))
        tr.decoder_idx.copy_(torch.tensor(s["dec"]))
    tr.model.dropout_masks = ReplayMasks(masks)
    return tr


def _scale(k, want):
    """The leaf's largest value; the key-conv bias gradients (zero in exact
    arithmetic) against their module's other conv-bias gradients."""
    if k.endswith("key_conv.bias"):
        prefix = k[: -len("key_conv.bias")]
        return max(np.abs(want[prefix + c + "_conv.bias"]).max() for c in ("query", "value", "out"))
    return np.abs(want[k]).max()


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_train_step_matches_the_pallas_route(setup, dtype_name):
    """The port's ``Trainer.loss_fn`` and gradients at dropout 0.3 (plain
    versions, CPU) against the JAX Trainer's on the TPU kernels' dropout
    forms, with the same masks. Float32: the loss to 1e-5 relative, each
    gradient leaf to 1e-4 normalised. bfloat16: no further from the Pallas
    route than the JAX XLA route (its attention dropout on the same masks,
    applied to bf16(p)), on the max and by half on the mean, or within
    F32_LIMIT."""
    s = setup
    kw = {} if dtype_name == "float32" else {"compute_dtype": "bfloat16"}
    jtr = _jax_trainer(s, "pallas", **kw)
    ds = jtr.train_dataset
    s_b = next(ds.batch_starts(B, shuffle=True, seed=3))
    src = np.stack([ds.data[:, t : t + HIS] for t in s_b])
    tgt = np.stack([ds.data[:, t + HIS : t + HIS + 12] for t in s_b])
    params = jax.tree.map(np.asarray, jtr.params)
    masks = []
    pallas_total, pallas = _jax_step(jtr, s, src, tgt, params, _recording_bernoulli(masks))
    assert len(masks) == SITES
    assert masks[0].shape == (B, N, 12, 2 * 12) and masks[2].shape == (B, 12, N, N)
    tr = _port_step(s, params, masks, f"torch_{dtype_name}", **kw)
    total, _, _ = tr.loss_fn(torch.tensor(src), torch.tensor(tgt), KL)
    grads = torch.autograd.grad(total, tr.state_tensors(), materialize_grads=True)
    assert tr.model.dropout_masks.served == SITES
    got = {k: g.double().numpy() for k, g in zip(tr.state_names, grads)}
    assert set(got) == set(pallas)
    if dtype_name == "float32":
        assert abs(total.item() - pallas_total) <= 1e-5 * abs(pallas_total)
        errs = {k: np.abs(got[k] - pallas[k]).max() / _scale(k, pallas) for k in got}
        assert max(errs.values()) <= 1e-4, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
        return
    replayed = []
    xla_total, xla = _jax_step(_jax_trainer(s, "xla", **kw), s, src, tgt, params,
                               _recording_bernoulli(replayed, replay=masks))
    assert len(replayed) == SITES
    assert abs(total.item() - pallas_total) <= abs(xla_total - pallas_total)
    for k in got:
        if k.endswith(JAX_CPU_BF16_SUMS):
            continue
        scale = _scale(k, pallas)
        err = np.abs(got[k] - pallas[k]) / scale
        ref = np.abs(xla[k] - pallas[k]) / scale
        assert err.max() <= max(ref.max(), F32_LIMIT), (k, err.max(), ref.max())
        assert err.mean() <= max(0.5 * ref.mean(), F32_LIMIT), (k, err.mean(), ref.mean())


def _port(s, name, **kw):
    return Trainer(D3STNConfig(**{**KW, **kw}, save_dir=str(s["root"] / name)), data=s["data"],
                   adj_matrix=s["adj"], sc_matrix=s["sc"], device="cpu")


def test_eval_is_deterministic_and_training_is_not(setup):
    """Eval, test forecasts and ``predict_idx`` run without dropout (the
    same twice, training mode restored); two train steps' seeds give other
    masks and one seed the same."""
    tr = _port(setup, "eval")
    starts = next(tr.val_dataset.batch_starts(B))
    assert tr.compute_eval_loss() == tr.compute_eval_loss()
    assert torch.equal(tr.predict_idx(starts), tr.predict_idx(starts))
    assert tr.model.training
    src, tgt = tr.windows(starts)
    losses = []
    for step in ((0, 0), (0, 0), (0, 1)):
        tr.set_dropout_step(*step)
        losses.append(tr.loss_fn(src, tgt, KL)[0].item())
    assert losses[0] == losses[1] != losses[2]


class RecordingMasks(DropoutMasks):
    """The real mask source, recording each model call's masks."""

    def __init__(self, seed):
        super().__init__(seed)
        self.calls = []

    def start(self):
        super().start()
        self.calls.append([])

    def keep(self, shape, keep, device):
        mask = super().keep(shape, keep, device)
        self.calls[-1].append(mask)
        return mask


def test_model_calls_of_one_step_share_their_masks(setup):
    """The midpoint solver calls the model twice in a step: both calls
    receive the same masks, which keep about 1 - dropout of their
    elements."""
    tr = _port(setup, "midpoint", solver="midpoint")
    tr.model.dropout_masks = RecordingMasks(7)
    src, tgt = tr.windows(next(tr.train_dataset.batch_starts(B)))
    total, _, _ = tr.loss_fn(src, tgt, KL)
    torch.autograd.grad(total, tr.state_tensors(), materialize_grads=True)
    calls = tr.model.dropout_masks.calls
    assert len(calls) == 2 and len(calls[0]) == SITES
    assert all(torch.equal(a, b) for a, b in zip(*calls))
    kept = torch.cat([m.reshape(-1) for m in calls[0]]).float().mean().item()
    assert abs(kept - 0.7) < 0.02


def test_gcn_pallas_with_dropout_warns(setup):
    tr = _port(setup, "warns", gcn_impl="pallas")
    src, tgt = tr.windows(next(tr.train_dataset.batch_starts(B)))
    with pytest.warns(UserWarning, match="dropout is active"):
        tr.loss_fn(src, tgt, KL)


# SYNTH's width and depth (examples/configs/SYNTH.json: d_model 64 = d_proj
# 32 + 2 x d_sect 16, 4 heads, 2+2 layers, top_k 4, with_adj and with_sc,
# Corr attention) at dropout 0.1, cut to 5 nodes, a history of 24 steps and
# a batch of 2
SYNTH_N, SYNTH_HIS, SYNTH_B = 5, 24, 2
SYNTH_KW = dict(KW, num_nodes=SYNTH_N, his_len=SYNTH_HIS, encoder_num_layers=2,
                decoder_num_layers=2, d_model=64, d_proj=32, d_sect=16, head=4, top_k=4,
                with_adj=True, with_sc=True, batch_size=SYNTH_B, dropout=0.1)
# 2+2 layers: the encoder's two (attention, residual, GCN scores, residual)
# and the decoder's two (two attentions with their residuals, GCN scores,
# residual)
SYNTH_SITES = 2 * 4 + 2 * 6


def _head_major_masks(masks):
    """The masks JAX's XLA route draws, with each attention mask [B, N, H,
    Tq, Tk] (``nn.Dropout`` on the softmax weights) as the kernel's and the
    port's head-major [B, N, Tq, H*Tk]."""
    out = []
    for m in masks:
        if m.ndim == 5:
            b, n, h, t_q, t_k = m.shape
            m = m.transpose(0, 1, 3, 2, 4).reshape(b, n, t_q, h * t_k)
        out.append(m)
    return out


def test_synth_width_step_matches_jax(tmp_path):
    """The SYNTH slice: the port's float32 ``Trainer.loss_fn`` and gradients
    at SYNTH's width and depth, dropout 0.1 (plain versions, CPU), against
    the JAX Trainer's with the same masks, on the port's initial parameters.
    The JAX side takes its ``attn_impl="xla"`` route, whose float32
    attention dropout multiplies the softmax weights by the mask as the TPU
    kernel does: this test takes ~10 s on one CPU worker with it and ~19 s
    with the interpret-mode Pallas route. On the card the port runs this
    shape on the dropout forms of K4 and K5 (``chip_smoke.py`` phase 6).
    Cut from SYNTH.json: the nodes (16 -> 5), the history (288 -> 24 steps)
    and the batch (16 -> 2); every width, the depth, top_k and the graph
    flags are SYNTH's. The loss within 1e-5 relative, each gradient leaf
    within 1e-4 normalised (``tests/test_torch_trainer.py``'s
    tolerances)."""
    rng = np.random.RandomState(11)
    data = synthetic_traffic_npz(num_nodes=SYNTH_N, seq_len=288)
    adj = (rng.rand(SYNTH_N, SYNTH_N) < 0.4).astype(np.float32)
    adj = np.maximum(adj, adj.T)
    sc = rng.rand(SYNTH_N, SYNTH_N).astype(np.float32)
    enc = (np.arange(SYNTH_HIS - 12, SYNTH_HIS) - 0.5 - 3 * rng.rand(12)).astype(np.float32)
    dec = (SYNTH_HIS - 1 - 2 * rng.rand(12)).astype(np.float32)
    s = dict(root=tmp_path, data=data, adj=adj, sc=sc, enc=enc, dec=dec)
    tr = Trainer(D3STNConfig(**SYNTH_KW, save_dir=str(tmp_path / "torch")), data=data,
                 adj_matrix=adj, sc_matrix=sc, device="cpu")
    # the port's initial parameters in place of the JAX init (whose trace and
    # compile at this depth cost 4 s)
    params = to_flax_params(tr.model)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxD3STN, "init",
                   lambda self, key, *xs: {"params": jax.tree.map(jnp.asarray, params)})
        jtr = JaxTrainer(JaxConfig(**SYNTH_KW, attn_impl="xla", gcn_impl="xla",
                                   save_dir=str(tmp_path / "jax")),
                         data=data, adj_matrix=adj, sc_matrix=sc)
    ds = jtr.train_dataset
    s_b = next(ds.batch_starts(SYNTH_B, shuffle=True, seed=3))
    src = np.stack([ds.data[:, t : t + SYNTH_HIS] for t in s_b])
    tgt = np.stack([ds.data[:, t + SYNTH_HIS : t + SYNTH_HIS + 12] for t in s_b])
    masks = []
    want_total, want = _jax_step(jtr, s, src, tgt, params, _recording_bernoulli(masks))
    assert len(masks) == SYNTH_SITES
    masks = _head_major_masks(masks)
    assert masks[0].shape == (SYNTH_B, SYNTH_N, 12, 4 * 12)
    with torch.no_grad():
        tr.encoder_idx.copy_(torch.tensor(enc))
        tr.decoder_idx.copy_(torch.tensor(dec))
    tr.model.dropout_masks = ReplayMasks(masks)
    total, _, _ = tr.loss_fn(torch.tensor(src), torch.tensor(tgt), KL)
    grads = torch.autograd.grad(total, tr.state_tensors(), materialize_grads=True)
    assert tr.model.dropout_masks.served == SYNTH_SITES
    got = {k: g.double().numpy() for k, g in zip(tr.state_names, grads)}
    assert set(got) == set(want)
    assert abs(total.item() - want_total) <= 1e-5 * abs(want_total)
    errs = {k: np.abs(got[k] - want[k]).max() / _scale(k, want) for k in got}
    assert max(errs.values()) <= 1e-4, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
