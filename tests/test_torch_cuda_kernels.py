"""The three CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: they need an NVIDIA card with ``nvcc`` (the kernels are
built at first call) and skip elsewhere. Run them on the card with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py``
(``tests/conftest.py`` imports JAX, which the card's machine need not have).
``chip_smoke.py`` holds the same kernels at the full PEMS08 shapes.
"""

import pytest
import torch

from paddlexde_tpu_torch.ops import _build, attn, gcn, spline

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _norm_err(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("derivative", [False, True])
def test_spline_kernel(dev, dtype, tol, derivative):
    g = torch.Generator(device=dev).manual_seed(0)
    series = torch.randn(3, 5, 50, 3, generator=g, device=dev, dtype=dtype)
    t = torch.arange(50, dtype=dtype, device=dev)
    q = torch.tensor([0.0, 2.5, 47.9, 48.2, 49.0, -2.0, 60.0], dtype=dtype, device=dev)
    before = _build.LAUNCHES["spline"]
    got = spline.gather_eval_kernel(series, t, q, derivative)
    assert _build.LAUNCHES["spline"] == before + 1
    assert _norm_err(got, spline.gather_eval_plain(series, t, q, derivative)) <= tol


# D=128 takes the register-tiled kernel (node tiles of 64 with an online
# softmax; N within one tile, across tiles, and at the PEMS04, PEMS03 and
# PEMS07 sizes); other D the generic one
@pytest.mark.parametrize("shape", [(2, 17, 3, 32), (1, 45, 2, 128), (2, 100, 2, 128),
                                   (1, 170, 3, 128), (1, 200, 1, 128), (1, 307, 2, 128),
                                   (1, 358, 2, 128), (1, 883, 1, 128), (2, 33, 1, 256)])
def test_gcn_kernel(dev, shape):
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(*shape, generator=g, device=dev)
    gate = torch.rand(shape[1], shape[1], generator=g, device=dev)
    got = gcn.gcn_spatial_mix_kernel(x, gate, 0.3)
    assert _norm_err(got, gcn.gcn_spatial_mix_plain(x, gate, 0.3)) <= 1e-4


def test_gcn_kernel_refuses_a_slice_beyond_shared_memory(dev):
    x = torch.zeros(1, 300, 1, 256, device=dev)  # the generic kernel stages whole slices
    with pytest.raises(ValueError, match="shared memory"):
        gcn.gcn_spatial_mix_kernel(x, torch.zeros(300, 300, device=dev))


# D3STN's three flag sets at its shape take the register-tiled kernel; the
# fourth set and the other shapes the generic one
@pytest.mark.parametrize("flags", [(False, False, False), (True, True, True), (True, False, False),
                                   (False, True, False)])
@pytest.mark.parametrize("b,n,tq,tk,d,heads", [(2, 5, 12, 12, 128, 8), (1, 7, 9, 9, 64, 4),
                                                (2, 3, 16, 16, 32, 2)])
def test_attention_kernel(dev, flags, b, n, tq, tk, d, heads):
    g = torch.Generator(device=dev).manual_seed(2)
    r = lambda *s: torch.randn(*s, generator=g, device=dev)
    arrays = [r(b, n, tq, d), r(b, n, tk, d), r(b, n, tk, d)]
    for _ in range(4):
        arrays += [r(3, d, d) / d ** 0.5, 0.1 * r(d)]
    got = attn.fused_temporal_attention_kernel(*arrays, *flags, heads)
    want = attn.fused_temporal_attention_plain(*arrays, *flags, heads)
    assert _norm_err(got, want) <= 1e-4
