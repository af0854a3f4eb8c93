"""The CUDA kernels against their plain PyTorch versions on the card.

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


# D3STN's three flag sets at its shape take the tensor-core kernel (tiles of
# 8 rows: B*N = 10, 37 and 340 leave a ragged last tile); the fourth set and
# the other shapes the generic one
@pytest.mark.parametrize("flags", [(False, False, False), (True, True, True), (True, False, False),
                                   (False, True, False)])
@pytest.mark.parametrize("b,n,tq,tk,d,heads", [(2, 5, 12, 12, 128, 8), (1, 37, 12, 12, 128, 8),
                                                (2, 170, 12, 12, 128, 8), (1, 7, 9, 9, 64, 4),
                                                (2, 3, 16, 16, 32, 2)])
def test_attention_kernel(dev, flags, b, n, tq, tk, d, heads):
    g = torch.Generator(device=dev).manual_seed(2)
    r = lambda *s: torch.randn(*s, generator=g, device=dev)
    arrays = [r(b, n, tq, d), r(b, n, tk, d), r(b, n, tk, d)]
    for _ in range(4):
        arrays += [r(3, d, d) / d ** 0.5, 0.1 * r(d)]
    before = _build.LAUNCHES["attn_fwd"]
    got = attn.fused_temporal_attention_kernel(*arrays, *flags, heads)
    assert _build.LAUNCHES["attn_fwd"] == before + 1
    want = attn.fused_temporal_attention_plain(*arrays, *flags, heads)
    assert _norm_err(got, want) <= 1e-4
    want64 = attn.fused_temporal_attention_plain(*[a.double() for a in arrays], *flags, heads,
                                                 dtype_name="float64")
    assert _norm_err(got.double(), want64) <= 1e-5


def _bitwise_twice(fn):
    """Run ``fn`` twice; every output must be the same bits both times."""
    first, second = fn(), fn()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    return first


# the backward kernels (K3 on the tensor cores in 3xTF32): D=128 at N within
# one node tile of 64, across tiles, at HZME's N=80 and PEMS08's N=170, and
# with B*T > 1 at an N not a multiple of 64 (the per-batch dgate partial sums
# over the T steps); D=64 for the synthetic configuration
@pytest.mark.parametrize("shape", [(2, 17, 3, 64), (1, 16, 12, 64), (2, 45, 2, 128),
                                   (1, 170, 3, 128), (1, 307, 1, 128), (2, 80, 3, 128),
                                   (3, 100, 4, 128), (2, 70, 5, 64)])
def test_gcn_bwd_kernel(dev, shape):
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(*shape, generator=g, device=dev)
    gate = torch.rand(shape[1], shape[1], generator=g, device=dev)
    cot = torch.randn(*shape, generator=g, device=dev)
    before = _build.LAUNCHES["gcn_bwd"]
    dx, dgate = _bitwise_twice(lambda: gcn.gcn_spatial_mix_bwd_kernel(x, gate, cot, 0.3))
    assert _build.LAUNCHES["gcn_bwd"] == before + 2
    want = gcn.gcn_spatial_mix_bwd_plain(x.double(), gate.double(), cot.double(), 0.3)
    assert _norm_err(dx.double(), want[0]) <= 1e-5
    assert _norm_err(dgate.double(), want[1]) <= 1e-5


# rows (B*N) not a multiple of the 8-row tiles; 340 rows take 4 weight-
# gradient splits of 85 rows
@pytest.mark.parametrize("flags", [(False, False, False), (True, True, True), (True, False, False)])
@pytest.mark.parametrize("b,n,d,heads", [(2, 5, 128, 8), (1, 7, 64, 4), (3, 11, 128, 8),
                                         (1, 37, 128, 8), (1, 37, 64, 4), (2, 170, 128, 8),
                                         (2, 170, 64, 4)])
def test_attention_bwd_kernel(dev, flags, b, n, d, heads):
    g = torch.Generator(device=dev).manual_seed(4)
    r = lambda *s: torch.randn(*s, generator=g, device=dev)
    arrays = [r(b, n, 12, d), r(b, n, 12, d), r(b, n, 12, d)]
    for _ in range(4):
        arrays += [r(3, d, d) / d ** 0.5, 0.1 * r(d)]
    cot = r(b, n, 12, d)
    before = _build.LAUNCHES["attn_bwd"]
    got = _bitwise_twice(lambda: attn.fused_temporal_attention_bwd_kernel(*arrays, cot, *flags,
                                                                          heads))
    assert _build.LAUNCHES["attn_bwd"] == before + 2
    want = attn.fused_temporal_attention_bwd_plain(*[a.double() for a in arrays], cot.double(),
                                                   *flags, heads)
    for a, w in zip(got, want):
        assert a.shape == w.shape
    assert max(attn.bwd_errors(got, want)) <= 1e-5


def test_autograd_through_the_kernels(dev):
    """Gradients of the kernel path equal those of the plain path, with
    ``mk is mq`` (self-attention: autograd adds the two input gradients)."""
    g = torch.Generator(device=dev).manual_seed(5)
    r = lambda *s: torch.randn(*s, generator=g, device=dev)
    x = r(2, 9, 12, 64).requires_grad_()
    gate = torch.rand(9, 9, generator=g, device=dev).requires_grad_()
    weights = [p.requires_grad_() for _ in range(4) for p in (r(3, 64, 64) / 8, 0.1 * r(64))]
    grads = []
    for impl in ("pallas", "xla"):
        y = gcn.gcn_spatial_mix(x, gate, 0.125, impl=impl)
        y = attn.fused_temporal_attention(y, y, x, *weights, False, False, False, 4, impl=impl)
        grads.append(torch.autograd.grad((y * y).sum(), [x, gate, *weights]))
    (dx, dgate, *dw), (dx_ref, dgate_ref, *dw_ref) = grads
    assert _norm_err(dx, dx_ref) <= 1e-4 and _norm_err(dgate, dgate_ref) <= 1e-4
    # the conv gradients as attn.bwd_errors groups them (x stands in for the
    # three input gradients)
    assert max(attn.bwd_errors([dx] * 3 + dw, [dx_ref] * 3 + dw_ref)) <= 1e-4
