"""Attention kernel K4's plain version against the JAX ``_ref_impl``, for the
three flag sets D3STN runs (encoder self, decoder masked self, decoder
source attention), float32, to 1e-5 normalised max-abs error."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlexde_tpu.ops import attn_pallas
from paddlexde_tpu_torch.ops import attn

TOL = 1e-5

FLAGS = {
    "encoder_self": (False, False, False),
    "decoder_masked_self": (True, True, True),
    "decoder_source": (True, False, False),
}


def _inputs(b=2, n=5, tq=12, tk=12, d=32, ks=3, seed=0):
    rng = np.random.RandomState(seed)
    f32 = lambda *s: rng.randn(*s).astype(np.float32)
    bound = np.sqrt(6.0 / (2 * ks * d))
    arrays = [f32(b, n, tq, d), f32(b, n, tk, d), f32(b, n, tk, d)]
    for _ in range(4):
        arrays.append((rng.uniform(-bound, bound, (ks, d, d))).astype(np.float32))
        arrays.append(0.1 * f32(d))
    return arrays


@pytest.mark.parametrize("heads", [2, 4])
@pytest.mark.parametrize("name", sorted(FLAGS))
def test_plain_matches_jax(name, heads):
    causal_q, causal_kv, is_mask = FLAGS[name]
    arrays = _inputs(seed=heads)
    want = attn_pallas._ref_impl(
        *[jnp.asarray(a) for a in arrays], causal_q=causal_q, causal_kv=causal_kv,
        is_mask=is_mask, heads=heads, dtype_name="float32",
    )
    got = attn.fused_temporal_attention(
        *[torch.tensor(a) for a in arrays], causal_q, causal_kv, is_mask, heads
    )
    want = np.asarray(want, np.float64)
    err = np.abs(got.numpy().astype(np.float64) - want).max() / np.abs(want).max()
    assert got.shape == want.shape and err <= TOL


def test_source_attention_with_shorter_memory():
    arrays = _inputs(tq=12, tk=7, seed=5)
    want = attn_pallas._ref_impl(
        *[jnp.asarray(a) for a in arrays], causal_q=True, causal_kv=False,
        is_mask=False, heads=4, dtype_name="float32",
    )
    got = attn.fused_temporal_attention(*[torch.tensor(a) for a in arrays], True, False, False, 4)
    want = np.asarray(want, np.float64)
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() <= TOL


def test_kernel_paths_refuse_cpu_tensors():
    arrays = [torch.tensor(a) for a in _inputs(b=1, n=2)]
    with pytest.raises(ValueError, match="CUDA"):
        attn.fused_temporal_attention(*arrays, False, False, False, 2, impl="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        attn.fused_temporal_attention_kernel(*arrays, False, False, False, 2)
