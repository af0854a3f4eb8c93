"""D3STN: delay-DE spatiotemporal transformer, as PyTorch modules.

Counterpart of ``paddlexde_tpu/models/d3stn/model.py``. Layout is
``[B, N, T, D]`` (N = sensors) throughout. The module tree mirrors the flax
parameter tree (``enc_0.self_attn.query_conv`` ...), so
:func:`~.weights.load_flax_params` maps a JAX checkpoint one to one.

Kept from the JAX model:

- the dense top-k mix matrix of the "Corr" attention, built once from the
  correlation adjacency (ties broken towards the lower index, as
  ``jax.lax.top_k`` does);
- the gate fold ``alpha * adj + beta * sc`` of the spatial GCN;
- the mix hoisted ahead of the temporal conv (the mix is row-stochastic, so
  it commutes with the conv), which makes the attention block per-node and
  lets it run as one fused kernel (``ops/attn.py``);
- LayerNorm epsilon 1e-5.

On the card the GCN and attention blocks run their forward and backward
kernels. ``dropout > 0`` in training mode (``model.train()``) applies the
JAX model's dropout sites with keep masks from :class:`DropoutMasks`, in
call order:

- in each attention sublayer, one mask ``[B, N, Tq, H*Tk]`` on the softmax
  weights (head-major, pre-scaled {0, 1/keep}: the TPU kernels' dropout
  form, ``fused_temporal_attention_dropout``; on the card the dropout forms
  of K4 and K5);
- in each GCN sublayer, one mask ``[B, T, N, N]`` on the softmax scores; with
  dropout active the GCN runs the JAX model's XLA form, which has no kernel
  in either package (``ops/gcn.py::gcn_spatial_mix_dropout``), and an
  explicit ``gcn_impl="pallas"`` warns;
- after each sublayer, one mask on its output h (flax ``nn.Dropout``: h
  divided by keep in h's dtype).

In eval mode (and at ``dropout == 0``) the model is deterministic.

``compute_dtype="bfloat16"`` trains and serves with the JAX model's cast
points: the input dense layers and the GCN projection compute in bfloat16
(inputs and weights rounded, a bfloat16 result, the bias added in
bfloat16), the attention and GCN blocks return bfloat16, and the top-k mix
uses the bfloat16-rounded matrix in float32 arithmetic. The embedding concatenation,
LayerNorm, the residual adds and the generator stay float32. The JAX model's
SiLU on bfloat16 rounds after each of its operations (:func:`_silu_bf16`).
The bfloat16 dense layer and SiLU carry their JAX gradients' rounding
points (:class:`_DenseBf16`, :class:`_SiluBf16`), the attention and GCN
blocks those of the TPU backward kernels (``ops/attn.py``, ``ops/gcn.py``).
"""

from __future__ import annotations

import math
import warnings
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..._device import resolve_device
from ...ops.attn import fused_temporal_attention, fused_temporal_attention_dropout
from ...ops.gcn import gcn_spatial_mix, gcn_spatial_mix_dropout
from .config import D3STNConfig

__all__ = ["D3STN", "DropoutMasks", "topk_mix_matrix"]


class DropoutMasks:
    """The keep masks of the model's dropout sites in training mode.

    Site i of a model call draws ``uniform < keep`` (the law of
    ``jax.random.bernoulli``) from a ``torch.Generator`` on the requested
    device, seeded from ``(step seed, i)``. Every model call within one
    step therefore sees the same masks, as JAX's ``apply`` with one rng
    does; the ``midpoint`` and ``rk4`` solvers call the model more than
    once per step. :meth:`set_step` gives the step seed, :meth:`start`
    begins a model call."""

    def __init__(self, seed: int = 0):
        self._generator = None
        self.set_step(seed)

    def set_step(self, seed: int) -> None:
        self._seed = int(seed)
        self._site = 0

    def start(self) -> None:
        self._site = 0

    def keep(self, shape, keep: float, device) -> torch.Tensor:
        """The next site's boolean keep mask of ``shape`` on ``device``."""
        device = torch.device(device)
        if self._generator is None or self._generator.device != device:
            self._generator = torch.Generator(device=device)
        site_seed = np.random.SeedSequence((self._seed, self._site)).generate_state(1, np.uint64)
        self._site += 1
        self._generator.manual_seed(int(site_seed[0]))
        return torch.rand(shape, generator=self._generator, device=device) < keep


def _residual_dropout(h, keep_mask, keep: float):
    """flax ``nn.Dropout`` on h: ``select(mask, h / keep, 0)`` with the
    division in h's dtype (in bfloat16 by bf16(keep), the quotient rounded
    to bfloat16). The divisor is a device tensor: PyTorch's CUDA division by
    a Python number multiplies by its reciprocal."""
    if h.dtype == torch.bfloat16:
        divisor = torch.full((), keep, device=h.device).to(torch.bfloat16).float()
        scaled = (h.float() / divisor).to(torch.bfloat16)
    else:
        scaled = h / torch.full((), keep, dtype=h.dtype, device=h.device)
    return torch.where(keep_mask, scaled, torch.zeros((), dtype=h.dtype, device=h.device))


def topk_mix_matrix(matrix: torch.Tensor, k: int) -> torch.Tensor:
    """Dense [N, N] row-mixing matrix M with M[n, idx[n, j]] =
    softmax(top-k scores of row n)[j]: ``mix(x) = M @ x`` over the node axis.

    A stable descending sort keeps the lower index among equal scores, which
    is ``jax.lax.top_k``'s rule (``torch.topk`` breaks ties otherwise, and
    rows of a sparse normalised adjacency are mostly equal zeros).
    """
    vals, idx = torch.sort(matrix, dim=-1, descending=True, stable=True)
    weights = torch.softmax(vals[:, :k], dim=-1)
    return torch.zeros_like(matrix).scatter_(1, idx[:, :k], weights)


def _mm_f32(a, b):
    """a @ b of bfloat16 matrices with float32 sums and a float32 result:
    cuBLAS's bfloat16 GEMM with a float32 output on the card, a float32
    product of the (exactly converted) values on the CPU, which has no such
    GEMM. So cuBLAS's reduced-precision flag cannot make them bfloat16
    sums."""
    if a.device.type == "cpu":
        return a.float() @ b.float()
    return torch.mm(a, b, out_dtype=torch.float32)


class _DenseBf16(torch.autograd.Function):
    """flax ``nn.Dense(dtype=bfloat16)`` on bfloat16 x [M, D_in], kernel
    w [D_out, D_in] and bias (or None): y = bf16(bf16(x w^T) + b). Its
    backward rounds where flax's transposed products round: dx = bf16(g w)
    and dw = bf16(g^T x), float32 sums; db the float32 sum of g, rounded
    once (JAX on the CPU sums it in bfloat16, an artefact of XLA's CPU
    backend)."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        ctx.has_bias = b is not None
        y = _mm_f32(x, w.t()).to(torch.bfloat16)
        return y if b is None else y + b

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = _mm_f32(g, w).to(torch.bfloat16)
        dw = _mm_f32(g.t(), x).to(torch.bfloat16)
        db = g.float().sum(dim=0).to(torch.bfloat16) if ctx.has_bias else None
        return dx, dw, db


def _dense(x, layer: nn.Linear, bf16: bool):
    """``layer(x)``; in bfloat16 as flax ``nn.Dense(dtype=bfloat16)``: x and
    the kernel rounded, the product (float32 sums) rounded, then the
    rounded bias added in bfloat16 (:class:`_DenseBf16`)."""
    if not bf16:
        return layer(x)
    bf = torch.bfloat16
    w = layer.weight.to(bf)
    b = None if layer.bias is None else layer.bias.to(bf)
    y = _DenseBf16.apply(x.to(bf).reshape(-1, x.shape[-1]), w, b)
    return y.reshape(*x.shape[:-1], w.shape[0])


class _SiluBf16(torch.autograd.Function):
    """``jax.nn.silu`` on bfloat16 and its JAX gradient, every operation
    rounded to bfloat16: s = 1 / (1 + exp(-x)) and y = x s forward; JAX's
    ``logistic`` rule backward, dx = bf16(g s) + bf16(bf16(x g) c) with
    c = bf16(s bf16(1 - s))."""

    @staticmethod
    def forward(ctx, x):
        s = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        return g * s + (x * g) * (s * (1 - s))


def _silu_bf16(x):
    """``jax.nn.silu`` on bfloat16 (``F.silu`` rounds once), with JAX's
    gradient (:class:`_SiluBf16`)."""
    return _SiluBf16.apply(x)


def _xavier_(param: torch.Tensor, fan_in: int, fan_out: int, generator) -> None:
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        param.uniform_(-bound, bound, generator=generator)


class ConvBank(nn.Module):
    """Parameters of one (1, K) temporal conv: ``kernel [K, D_in, D_out]``
    (flax ``nn.Conv``'s kernel without its leading 1) and ``bias [D_out]``."""

    def __init__(self, kernel_size: int, d_in: int, d_out: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(kernel_size, d_in, d_out))
        self.bias = nn.Parameter(torch.zeros(d_out))

    def init_weights(self, generator):
        ks, d_in, d_out = self.kernel.shape
        _xavier_(self.kernel, ks * d_in, ks * d_out, generator)
        nn.init.zeros_(self.bias)


class MultiHeadAttentionAwareTemporalContext(nn.Module):
    """Temporal-context-aware multi-head attention (reference
    ``attention.py:100-256``): mix -> fused conv/MHA/conv block."""

    def __init__(self, cfg: D3STNConfig, mix_matrix: Optional[torch.Tensor],
                 query_causal: bool = False, key_causal: bool = False):
        super().__init__()
        self.cfg = cfg
        self.query_causal = query_causal
        self.key_causal = key_causal
        ks, d = cfg.kernel_size, cfg.d_model
        self.query_conv = ConvBank(ks, d, d)
        self.key_conv = ConvBank(ks, d, d)
        self.value_conv = ConvBank(ks, d, d)
        self.out_conv = ConvBank(ks, d, d)
        self.register_buffer("mix_matrix", mix_matrix, persistent=False)

    def _mix(self, x):
        if self.mix_matrix is None:
            return x
        mix = self.mix_matrix
        if self.cfg.compute_dtype == "bfloat16":  # the JAX model rounds the matrix
            mix = mix.to(torch.bfloat16)
        return torch.einsum("nm,bmtd->bntd", mix.to(x.dtype), x)

    def forward(self, query, key, value, is_mask: bool = False, masks=None):
        cfg = self.cfg
        mq = self._mix(query)
        mk = mq if (key is query and self.mix_matrix is not None) else self._mix(key)
        convs = (self.query_conv, self.key_conv, self.value_conv, self.out_conv)
        weights = [p for c in convs for p in (c.kernel, c.bias)]
        flags = (self.query_causal, self.key_causal, bool(is_mask), cfg.head)
        if masks is None:
            return fused_temporal_attention(mq, mk, value, *weights, *flags, cfg.compute_dtype,
                                            impl=cfg.attn_impl)
        # the JAX model's m.astype(float32) / keep: {0, 1 / f32(keep)}
        keep = 1.0 - cfg.dropout
        m = masks.keep((*mq.shape[:3], cfg.head * mk.shape[2]), keep, mq.device)
        dm = m.to(torch.float32) * float(np.float32(1.0) / np.float32(keep))
        return fused_temporal_attention_dropout(mq, mk, value, *weights, dm, *flags,
                                                cfg.compute_dtype, impl=cfg.attn_impl)


class SpatialAttentionGCN(nn.Module):
    """Data-dependent spatial attention gated by static adjacencies
    (reference ``graphconv.py:57-125``)."""

    def __init__(self, cfg: D3STNConfig, adj_matrix: torch.Tensor, sc_matrix: torch.Tensor):
        super().__init__()
        self.cfg = cfg
        self.alpha = nn.Parameter(torch.full((1,), 0.5))
        self.beta = nn.Parameter(torch.full((1,), 0.5))
        self.proj = nn.Linear(cfg.d_model, cfg.d_model, bias=False)
        self.register_buffer("adj_matrix", adj_matrix, persistent=False)
        self.register_buffer("sc_matrix", sc_matrix, persistent=False)

    def gate(self):
        cfg = self.cfg
        if cfg.with_sc and not cfg.with_adj:
            return self.beta * self.sc_matrix
        if cfg.with_adj and cfg.with_sc:
            return self.alpha * self.adj_matrix + self.beta * self.sc_matrix
        return self.alpha * self.adj_matrix

    def forward(self, x, masks=None):
        cfg = self.cfg
        scale2 = 1.0 / math.sqrt(cfg.d_model)
        if masks is None:
            x_gcn = gcn_spatial_mix(x, self.gate(), scale2, cfg.compute_dtype, impl=cfg.gcn_impl)
        else:
            if cfg.gcn_impl == "pallas":  # the JAX model's warning
                warnings.warn("gcn_impl='pallas' requested but dropout is active: the fused "
                              "kernel has no dropout support, falling back to the XLA path "
                              "for this (training) call.", stacklevel=2)
            b, n, t, _ = x.shape
            keep = 1.0 - cfg.dropout
            x_gcn = gcn_spatial_mix_dropout(x, self.gate(), scale2,
                                            masks.keep((b, t, n, n), keep, x.device), keep,
                                            cfg.compute_dtype)
        if cfg.compute_dtype == "bfloat16":
            return _silu_bf16(_dense(x_gcn, self.proj, True))
        return F.silu(self.proj(x_gcn))


class TemporalSectionEmbedding(nn.Module):
    """Day-of-week / time-of-day section embedding of the index channel
    ``axis`` of x (clipped, then truncated to an integer)."""

    def __init__(self, cfg: D3STNConfig, section_nums: int, axis: int):
        super().__init__()
        self.section_nums = section_nums
        self.axis = axis
        self.embed = nn.Embedding(section_nums, cfg.d_sect)

    def forward(self, x):
        idx = x[..., self.axis].clamp(0, self.section_nums - 1).to(torch.long)
        return self.embed(idx)


class AdaptiveEmbedding(nn.Module):
    """Learned [N, T, d_adaptive] embedding broadcast over batch."""

    def __init__(self, cfg: D3STNConfig):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(cfg.num_nodes, cfg.tgt_len, cfg.d_adaptive))

    def forward(self, x):
        return self.embedding.unsqueeze(0).expand((x.shape[0],) + self.embedding.shape)


class SublayerConnection(nn.Module):
    """Pre-norm residual wrapper (reference ``endecoder.py:5-29``); with
    ``masks`` the sublayer's output goes through dropout."""

    def __init__(self, cfg: D3STNConfig):
        super().__init__()
        self.cfg = cfg
        self.norm = nn.LayerNorm(cfg.d_model, eps=1e-5)

    def forward(self, x, sublayer, masks=None):
        h = sublayer(self.norm(x))
        if masks is not None:
            keep = 1.0 - self.cfg.dropout
            h = _residual_dropout(h, masks.keep(h.shape, keep, h.device), keep)
        return x + h


class EncoderLayer(nn.Module):
    def __init__(self, cfg, adj_matrix, sc_matrix, mix_matrix):
        super().__init__()
        self.self_attn = MultiHeadAttentionAwareTemporalContext(cfg, mix_matrix, False, False)
        self.gcn = SpatialAttentionGCN(cfg, adj_matrix, sc_matrix)
        self.sub0 = SublayerConnection(cfg)
        self.sub1 = SublayerConnection(cfg)

    def forward(self, x, masks=None):
        x = self.sub0(x, lambda h: self.self_attn(h, h, h, masks=masks), masks)
        return self.sub1(x, lambda h: self.gcn(h, masks), masks)


class DecoderLayer(nn.Module):
    def __init__(self, cfg, adj_matrix, sc_matrix, mix_matrix):
        super().__init__()
        self.self_attn = MultiHeadAttentionAwareTemporalContext(cfg, mix_matrix, True, True)
        self.src_attn = MultiHeadAttentionAwareTemporalContext(cfg, mix_matrix, True, False)
        self.gcn = SpatialAttentionGCN(cfg, adj_matrix, sc_matrix)
        self.sub0 = SublayerConnection(cfg)
        self.sub1 = SublayerConnection(cfg)
        self.sub2 = SublayerConnection(cfg)

    def forward(self, x, memory, masks=None):
        x = self.sub0(x, lambda h: self.self_attn(h, h, h, is_mask=True, masks=masks), masks)
        x = self.sub1(x, lambda h: self.src_attn(h, memory, memory, masks=masks), masks)
        return self.sub2(x, lambda h: self.gcn(h, masks), masks)


class D3STN(nn.Module):
    """The full model: ``forward(src, tgt)``.

    ``src`` is the history evaluated at the encoder lags ``[B, N, L, 3]``
    (channels: value, day-of-week index, time-of-day index); ``tgt`` the
    decoder input. ``adj_matrix``/``sc_matrix`` are the NORMALISED
    adjacencies ``[N, N]``. Parameters are drawn from ``generator`` (a CPU
    ``torch.Generator``; a fresh default one when None) with the JAX model's
    initialisers, then the module moves to ``device`` (CUDA by default).
    ``dropout_masks`` (a :class:`DropoutMasks`, seeded from ``cfg.seed``)
    serves the dropout sites in training mode.
    """

    def __init__(self, cfg: D3STNConfig, adj_matrix, sc_matrix, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        adj = torch.as_tensor(adj_matrix, dtype=torch.float32).cpu()
        sc = torch.as_tensor(sc_matrix, dtype=torch.float32).cpu()
        mix = topk_mix_matrix(sc, cfg.top_k) if cfg.attention == "Corr" else None

        self.encoder_dense = nn.Linear(cfg.encoder_input_size, cfg.d_proj)
        self.decoder_dense = nn.Linear(cfg.decoder_input_size, cfg.d_proj)
        self.temporal_section_week = TemporalSectionEmbedding(cfg, 7, axis=1)
        self.temporal_section_day = TemporalSectionEmbedding(cfg, 288, axis=2)
        # one adaptive embedding shared by encoder and decoder (the reference
        # reuses the encoder's in decode)
        self.adaptive_embedding_encoder = AdaptiveEmbedding(cfg) if cfg.d_adaptive > 0 else None
        self.encoder_layers = []
        for i in range(cfg.encoder_num_layers):
            layer = EncoderLayer(cfg, adj, sc, mix)
            self.add_module(f"enc_{i}", layer)
            self.encoder_layers.append(layer)
        self.decoder_layers = []
        for i in range(cfg.decoder_num_layers):
            layer = DecoderLayer(cfg, adj, sc, mix)
            self.add_module(f"dec_{i}", layer)
            self.decoder_layers.append(layer)
        self.encoder_norm = nn.LayerNorm(cfg.d_model, eps=1e-5)
        self.decoder_norm = nn.LayerNorm(cfg.d_model, eps=1e-5)
        self.generator = nn.Linear(cfg.d_model, cfg.decoder_output_size)
        self.init_weights(generator if generator is not None else torch.Generator())
        self.to(device)
        self.dropout_masks = DropoutMasks(cfg.seed)

    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX model's initialisers: xavier-uniform kernels, zero biases,
        0.5 gates, unit LayerNorm, normal(0, 1/sqrt(n)) embeddings."""
        for module in self.modules():
            if isinstance(module, ConvBank):
                module.init_weights(generator)
            elif isinstance(module, nn.Linear):
                _xavier_(module.weight, module.in_features, module.out_features, generator)
                if module.bias is not None:
                    nn.init.zeros_(module.bias)
            elif isinstance(module, nn.Embedding):
                with torch.no_grad():
                    module.weight.normal_(0.0, 1.0 / math.sqrt(module.num_embeddings),
                                          generator=generator)
            elif isinstance(module, AdaptiveEmbedding):
                n, t, d = module.embedding.shape
                _xavier_(module.embedding, t * n, d * n, generator)

    def _embed(self, x, dense):
        value = _dense(x[..., :1], dense, self.cfg.compute_dtype == "bfloat16")
        parts = [value.float(), self.temporal_section_week(x), self.temporal_section_day(x)]
        if self.adaptive_embedding_encoder is not None:
            parts.append(self.adaptive_embedding_encoder(parts[0]))
        return torch.cat(parts, dim=-1)

    def encode(self, src, masks=None):
        x = self._embed(src, self.encoder_dense)
        for layer in self.encoder_layers:
            x = layer(x, masks)
        return self.encoder_norm(x)

    def decode(self, memory, tgt, masks=None):
        x = self._embed(tgt, self.decoder_dense)
        for layer in self.decoder_layers:
            x = layer(x, memory, masks)
        return self.generator(self.decoder_norm(x))

    def forward(self, src, tgt):
        masks = None
        if self.training and self.cfg.dropout > 0:
            masks = self.dropout_masks
            masks.start()
        return self.decode(self.encode(src, masks), tgt, masks)
