"""Attention kernel K4's plain version against the JAX ``_ref_impl``, for the
three flag sets D3STN runs (encoder self, decoder masked self, decoder
source attention), float32, to 1e-5 normalised max-abs error."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlexde_tpu.ops import attn_pallas
from paddlexde_tpu_torch.ops import attn


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs 6 workers on 8 cores: torch's default of one compute
    thread per core in each worker (spinning between the tiny ops here)
    would take cores from the JAX tests beside it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


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


@pytest.fixture
def _f32_jax():
    """The TPU kernel in interpret mode computes in float32 (as its own tests
    run it); restore the suite's x64 setting afterwards."""
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", before)


@pytest.mark.parametrize("name", sorted(FLAGS))
def test_plain_backward_matches_autograd_float64(name):
    """K5's plain backward (the kernel's explicit math) against autograd of
    the plain forward, float64, to 1e-12 (normalised by ``bwd_errors``)."""
    flags = FLAGS[name]
    arrays = [torch.tensor(a.astype(np.float64), requires_grad=True)
              for a in _inputs(b=2, n=3, tq=6, tk=6, d=16, seed=3)]
    g = torch.tensor(np.random.RandomState(4).randn(2, 3, 6, 16))
    y = attn.fused_temporal_attention_plain(*arrays, *flags, 2, "float64")
    want = torch.autograd.grad(y, arrays, g)
    got = attn.fused_temporal_attention_bwd_plain(*[a.detach() for a in arrays], g, *flags, 2)
    assert max(attn.bwd_errors(got, want)) <= 1e-12


# mk is mq where the model passes one tensor twice: encoder and decoder
# self-attention
@pytest.mark.parametrize("name,self_attention", [("encoder_self", False), ("encoder_self", True),
                                                 ("decoder_masked_self", True),
                                                 ("decoder_source", False)])
def test_plain_backward_matches_jax_tpu_kernel(_f32_jax, name, self_attention):
    """K5's plain backward against ``jax.vjp`` of the TPU kernel
    (``_bwd_kernel`` in interpret mode), float32, to 1e-5 (normalised by
    ``bwd_errors``);
    with ``mk is mq`` the two input gradients add up, as autograd does when
    the model passes one tensor twice."""
    flags = FLAGS[name]
    arrays = _inputs(b=2, n=3, tq=6, tk=6, d=16, seed=5)
    g = np.random.RandomState(6).randn(2, 3, 6, 16).astype(np.float32)
    if self_attention:
        arrays[1] = arrays[0]
    jarr = [jnp.asarray(a) for a in arrays]

    def kernel(mq, mk, *rest):
        return attn_pallas.fused_temporal_attention(
            mq, mq if self_attention else mk, *rest, *flags, 2, "float32", True, True, False)

    _, vjp = jax.vjp(kernel, *jarr)
    want = list(vjp(jnp.asarray(g)))
    got = list(attn.fused_temporal_attention_bwd_plain(
        *[torch.tensor(a) for a in arrays], torch.tensor(g), *flags, 2))
    if self_attention:  # the kernel function ignores mk: its gradient is 0
        got[0], got[1] = got[0] + got[1], torch.zeros_like(got[1])
    assert max(attn.bwd_errors(got, [np.array(w) for w in want])) <= TOL


def test_autograd_adds_both_gradients_when_mk_is_mq():
    """The routed function on CPU tensors, one tensor as mq and mk."""
    arrays = [torch.tensor(a.astype(np.float64)) for a in _inputs(b=1, n=2, tq=6, tk=6, d=16)]
    x = arrays[0].clone().requires_grad_()
    g = torch.tensor(np.random.RandomState(8).randn(1, 2, 6, 16))
    y = attn.fused_temporal_attention(x, x, *arrays[2:], True, True, True, 2, "float64")
    (got,) = torch.autograd.grad(y, x, g)
    want = attn.fused_temporal_attention_bwd_plain(x.detach(), x.detach(), *arrays[2:], g,
                                                   True, True, True, 2)
    torch.testing.assert_close(got, want[0] + want[1], rtol=1e-12, atol=1e-12)


# PEMS08 at batch 32 (B, N, T, D, heads, K): each work function's bounds in ms,
# float32 on the CUDA cores and with the products in 3xTF32, by hand:
# products / (494.7e12 / 3) + other / 67e12 against bytes / 3.35e12
_PEMS08 = (32, 170, 12, 128, 8, 3)
BOUNDS = {
    "attn_work": (_PEMS08, 0.38939, 0.16193),
    "attn_bwd_work": (_PEMS08, 1.07229, 0.44679),
    "gcn_work": (_PEMS08[:4], 0.085634, 0.035285),
    "gcn_bwd_work": (_PEMS08[:4], 0.21367, 0.087799),
}


@pytest.mark.parametrize("name", sorted(BOUNDS))
def test_bounds_at_pems08(name):
    from paddlexde_tpu_torch.ops import timing

    args, f32_ms, tf32_ms = BOUNDS[name]
    work = getattr(timing, name)(*args)
    assert timing.bound_ms(work) == (pytest.approx(f32_ms, rel=1e-4), "operations")
    assert timing.bound_3xtf32_ms(work) == (pytest.approx(tf32_ms, rel=1e-4), "operations")
    want = (work.products / (timing.PEAK_TF32_FLOPS / 3) + work.other / timing.PEAK_F32_FLOPS) * 1e3
    assert timing.bound_3xtf32_ms(work)[0] == pytest.approx(want, rel=1e-12)
    # bytes never bind these kernels: K4 moves 133.8 MB (0.040 ms)
    assert work.bytes / timing.PEAK_BYTES_PER_S * 1e3 < tf32_ms


@pytest.mark.parametrize("x_bytes, want", [(4, (0.020929, "operations")),
                                            (2, (0.010012, "bytes"))])
def test_bf16_gcn_bound_takes_float32_scores_at_3xtf32(x_bytes, want):
    """The bfloat16 GCN forward at PEMS08, batch 32: the scores of a float32
    x (2 N^2 D per slice) at 494.7/3 TFLOP/s, the mix at 989 TFLOP/s, the
    softmax at 67 TFLOP/s; a bfloat16 x takes every product at 989 and its
    bytes bind."""
    from paddlexde_tpu_torch.ops import timing

    work = timing.gcn_work(*_PEMS08[:4], x_bytes=x_bytes, y_bytes=2)
    assert timing.bound_bf16_ms(work) == (pytest.approx(want[0], rel=1e-4), want[1])
    assert timing.bound_3xtf32_ms(work) == timing.bound_3xtf32_ms(timing.gcn_work(*_PEMS08[:4]))


def test_bound_without_products_is_the_cuda_core_bound():
    from paddlexde_tpu_torch.ops import timing

    for work in (timing.Work(3.35e9, 0, 1e6), timing.Work(1e3, 0, 6.7e10)):
        assert timing.bound_3xtf32_ms(work) == timing.bound_ms(work)
    assert timing.bound_ms(timing.Work(3.35e9, 0, 1e6)) == (pytest.approx(1.0), "bytes")
    assert timing.bound_ms(timing.Work(1e3, 0, 6.7e10)) == (pytest.approx(1.0), "operations")
