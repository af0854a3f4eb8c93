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

Trains and serves with ``dropout == 0`` (every shipped config): on the card
the GCN and attention blocks run their forward and backward kernels. Dropout
in training mode is not ported (the kernels have no dropout input yet,
ROADMAP.md).

``compute_dtype="bfloat16"`` serves with the JAX model's cast points: the
input dense layers and the GCN projection compute in bfloat16 (inputs and
weights rounded, a bfloat16 result, the bias added in bfloat16), the
attention and GCN blocks return bfloat16, and the top-k mix uses the
bfloat16-rounded matrix in float32 arithmetic. The embedding concatenation,
LayerNorm, the residual adds and the generator stay float32. The JAX model's
SiLU on bfloat16 rounds after each of its operations (:func:`_silu_bf16`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..._device import resolve_device
from ...ops.attn import fused_temporal_attention
from ...ops.gcn import gcn_spatial_mix
from .config import D3STNConfig

__all__ = ["D3STN", "topk_mix_matrix"]


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


def _dense(x, layer: nn.Linear, bf16: bool):
    """``layer(x)``; in bfloat16 as flax ``nn.Dense(dtype=bfloat16)``: x and
    the kernel rounded, the product (float32 sums) rounded, then the
    rounded bias added in bfloat16. The sums go into a float32 result
    (cuBLAS's bfloat16 GEMM with a float32 output on the card, a float32
    product of the rounded values elsewhere), so cuBLAS's reduced-precision
    flag cannot make them bfloat16 sums."""
    if not bf16:
        return layer(x)
    bf = torch.bfloat16
    x, w = x.to(bf), layer.weight.to(bf)
    if x.is_cuda:
        y = torch.mm(x.reshape(-1, x.shape[-1]), w.t(), out_dtype=torch.float32)
        y = y.reshape(*x.shape[:-1], w.shape[0])
    else:
        y = F.linear(x.float(), w.float())
    y = y.to(bf)
    return y if layer.bias is None else y + layer.bias.to(bf)


def _silu_bf16(x):
    """``jax.nn.silu`` on bfloat16: x * (1 / (1 + exp(-x))) with every
    operation rounded to bfloat16 (``F.silu`` rounds once)."""
    return x * (1 / (1 + torch.exp(-x)))


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

    def forward(self, query, key, value, is_mask: bool = False):
        cfg = self.cfg
        mq = self._mix(query)
        mk = mq if (key is query and self.mix_matrix is not None) else self._mix(key)
        convs = (self.query_conv, self.key_conv, self.value_conv, self.out_conv)
        weights = [p for c in convs for p in (c.kernel, c.bias)]
        return fused_temporal_attention(
            mq, mk, value, *weights, self.query_causal, self.key_causal,
            bool(is_mask), cfg.head, cfg.compute_dtype, impl=cfg.attn_impl,
        )


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

    def forward(self, x):
        cfg = self.cfg
        x_gcn = gcn_spatial_mix(
            x, self.gate(), 1.0 / math.sqrt(cfg.d_model), cfg.compute_dtype,
            impl=cfg.gcn_impl,
        )
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
    """Pre-norm residual wrapper (reference ``endecoder.py:5-29``)."""

    def __init__(self, cfg: D3STNConfig):
        super().__init__()
        self.norm = nn.LayerNorm(cfg.d_model, eps=1e-5)

    def forward(self, x, sublayer):
        return x + sublayer(self.norm(x))


class EncoderLayer(nn.Module):
    def __init__(self, cfg, adj_matrix, sc_matrix, mix_matrix):
        super().__init__()
        self.self_attn = MultiHeadAttentionAwareTemporalContext(cfg, mix_matrix, False, False)
        self.gcn = SpatialAttentionGCN(cfg, adj_matrix, sc_matrix)
        self.sub0 = SublayerConnection(cfg)
        self.sub1 = SublayerConnection(cfg)

    def forward(self, x):
        x = self.sub0(x, lambda h: self.self_attn(h, h, h))
        return self.sub1(x, self.gcn)


class DecoderLayer(nn.Module):
    def __init__(self, cfg, adj_matrix, sc_matrix, mix_matrix):
        super().__init__()
        self.self_attn = MultiHeadAttentionAwareTemporalContext(cfg, mix_matrix, True, True)
        self.src_attn = MultiHeadAttentionAwareTemporalContext(cfg, mix_matrix, True, False)
        self.gcn = SpatialAttentionGCN(cfg, adj_matrix, sc_matrix)
        self.sub0 = SublayerConnection(cfg)
        self.sub1 = SublayerConnection(cfg)
        self.sub2 = SublayerConnection(cfg)

    def forward(self, x, memory):
        x = self.sub0(x, lambda h: self.self_attn(h, h, h, is_mask=True))
        x = self.sub1(x, lambda h: self.src_attn(h, memory, memory))
        return self.sub2(x, self.gcn)


class D3STN(nn.Module):
    """The full model: ``forward(src, tgt)``.

    ``src`` is the history evaluated at the encoder lags ``[B, N, L, 3]``
    (channels: value, day-of-week index, time-of-day index); ``tgt`` the
    decoder input. ``adj_matrix``/``sc_matrix`` are the NORMALISED
    adjacencies ``[N, N]``. Parameters are drawn from ``generator`` (a CPU
    ``torch.Generator``; a fresh default one when None) with the JAX model's
    initialisers, then the module moves to ``device`` (CUDA by default).
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

    def encode(self, src):
        x = self._embed(src, self.encoder_dense)
        for layer in self.encoder_layers:
            x = layer(x)
        return self.encoder_norm(x)

    def decode(self, memory, tgt):
        x = self._embed(tgt, self.decoder_dense)
        for layer in self.decoder_layers:
            x = layer(x, memory)
        return self.generator(self.decoder_norm(x))

    def forward(self, src, tgt):
        if self.training and self.cfg.dropout > 0:
            raise NotImplementedError(
                "dropout in training mode is not ported (the kernels have no "
                "dropout input yet, ROADMAP.md); train with dropout=0 or call "
                ".eval() to serve"
            )
        return self.decode(self.encode(src), tgt)
