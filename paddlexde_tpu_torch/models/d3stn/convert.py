"""Checkpoint conversion: reference D3STN weights -> the flax parameter tree.

The port's own copy of ``paddlexde_tpu/models/d3stn/convert.py``
(``convert_reference_state_dict``, ``:60``; the rules ``:31-40``; the conv
transpose ``:28``). Given the reference PaddleXDE ``state_dict`` exported to
a plain ``{name: np.ndarray}`` dict (e.g. ``np.savez(path, **{k: v.numpy()
for k, v in paddle.load(f).items()})`` on a machine with paddle), it gives
the flax D3STN tree of numpy arrays, array for array the JAX function's.
The port's model takes that tree through
:func:`~.weights.load_flax_params`, the one function that carries weights
across, so no second mapping exists::

    params, unmatched = convert_reference_state_dict(state, cfg)
    load_flax_params(model, params)      # or Predictor(cfg, params, ...)

Weight layouts:

- paddle ``nn.Linear`` kernels are [in, out], as flax ``Dense``: no
  transpose;
- paddle NHWC ``Conv2D`` kernels are [out, in, kh, kw]; flax ``Conv``
  expects [kh, kw, in, out]: transpose (2, 3, 1, 0);
- paddle ``nn.Embedding`` and ``LayerNorm`` map one to one.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .config import D3STNConfig

__all__ = ["convert_reference_state_dict", "REFERENCE_KEY_RULES"]


def _conv_t(w):
    return np.transpose(w, (2, 3, 1, 0))


def _id(w):
    return w


# (reference name -> flax path, transform) for the layers outside the stacks
REFERENCE_KEY_RULES = [
    ("encoder_dense.weight", "encoder_dense/kernel", _id),
    ("encoder_dense.bias", "encoder_dense/bias", _id),
    ("decoder_dense.weight", "decoder_dense/kernel", _id),
    ("decoder_dense.bias", "decoder_dense/bias", _id),
    ("temporal_section_week.embedding.weight", "temporal_section_week/Embed_0/embedding", _id),
    ("temporal_section_day.embedding.weight", "temporal_section_day/Embed_0/embedding", _id),
    ("generator.weight", "generator/kernel", _id),
    ("generator.bias", "generator/bias", _id),
]

_ATTN_SUB = {
    "query_conv": "query_conv/Conv_0",
    "key_conv": "key_conv/Conv_0",
    "value_conv": "value_conv/Conv_0",
    "out_conv": "out_conv/Conv_0",
}


def _set(tree: Dict, path: str, value):
    *parents, leaf = path.split("/")
    node = tree
    for p in parents:
        node = node.setdefault(p, {})
    node[leaf] = value


def _layer_rules(layer_prefix: str, idx: int, our_prefix: str):
    """The rules of one encoder or decoder layer: both attention blocks'
    four convs, the GCN's linear and gates, three sublayer norms."""
    ref, ours = f"{layer_prefix}.layers.{idx}", f"{our_prefix}_{idx}"
    rules = []
    for sub in ("self_attn", "src_attn"):
        for ref_c, our_c in _ATTN_SUB.items():
            rules.append((f"{ref}.{sub}.{ref_c}.weight", f"{ours}/{sub}/{our_c}/kernel", _conv_t))
            rules.append((f"{ref}.{sub}.{ref_c}.bias", f"{ours}/{sub}/{our_c}/bias", _id))
    rules.append((f"{ref}.feed_forward_gcn.linear.weight", f"{ours}/gcn/Dense_0/kernel", _id))
    for g in ("alpha", "beta"):
        rules.append((f"{ref}.feed_forward_gcn.{g}", f"{ours}/gcn/{g}", _id))
    for s in range(3):
        rules.append((f"{ref}.sublayer.{s}.norm.weight", f"{ours}/sub{s}/LayerNorm_0/scale", _id))
        rules.append((f"{ref}.sublayer.{s}.norm.bias", f"{ours}/sub{s}/LayerNorm_0/bias", _id))
    return rules


def convert_reference_state_dict(state: Dict[str, np.ndarray], cfg: D3STNConfig):
    """Convert a numpy-exported reference ``state_dict`` to the flax tree.

    Returns ``(params, unmatched_keys)``: the dense projections, section
    embeddings, attention convs, GCN linears and gates, layer norms and the
    generator. Reference keys that no rule names come back in
    ``unmatched_keys``, never dropped silently.
    """
    rules = list(REFERENCE_KEY_RULES)
    for i in range(cfg.encoder_num_layers):
        rules += _layer_rules("encoder", i, "enc")
    for i in range(cfg.decoder_num_layers):
        rules += _layer_rules("decoder", i, "dec")
    rules += [
        ("encoder.norm.weight", "encoder_norm/scale", _id),
        ("encoder.norm.bias", "encoder_norm/bias", _id),
        ("decoder.norm.weight", "decoder_norm/scale", _id),
        ("decoder.norm.bias", "decoder_norm/bias", _id),
        ("adaptive_embedding_encoder.embedding", "adaptive_embedding_encoder/embedding", _id),
    ]
    rule_map = {ref: (ours, fn) for ref, ours, fn in rules}

    params: Dict = {}
    unmatched = []
    for key, value in state.items():
        if key in rule_map:
            ours, fn = rule_map[key]
            _set(params, ours, np.asarray(fn(np.asarray(value))))
        else:
            unmatched.append(key)
    return params, unmatched
