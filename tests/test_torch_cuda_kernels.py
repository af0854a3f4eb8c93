"""The CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: they need an NVIDIA card with ``nvcc`` (the kernels are
built at first call) and skip elsewhere. Run them on the card with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py``
(``tests/conftest.py`` imports JAX, which the card's machine need not have).
``chip_smoke.py`` holds the same kernels at the full PEMS08 shapes.
"""

import itertools

import pytest
import torch

from paddlexde_tpu_torch.ops import _build, attn, gcn, spline
from paddlexde_tpu_torch.ops.compare import bf16_errors

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def cases(names, values):
    """``pytest.mark.parametrize`` as one test item: the test runs every case
    (stacked, every combination) and fails naming each case that failed.
    Without a card the item skips once, where a parametrised test would put
    one skipped item a case into the CPU suite, whose xdist workers take
    chunks of tests sized by the number of items still pending."""
    names = names.split(",")

    def wrap(fn):
        body, axes = getattr(fn, "cases_of", (fn, []))
        axes = [(names, values)] + axes

        def test(dev):
            combos = list(itertools.product(*(v for _, v in axes)))
            failed = []
            for combo in combos:
                case = {}
                for (ns, _), v in zip(axes, combo):
                    case.update(zip(ns, v) if len(ns) > 1 else {ns[0]: v})
                try:
                    body(dev, **case)
                except (AssertionError, pytest.fail.Exception) as e:
                    failed.append(f"{case}: {e}")
            assert not failed, f"{len(failed)} of {len(combos)} cases:\n" + "\n".join(failed)

        test.cases_of = (body, axes)
        test.__name__, test.__doc__ = body.__name__, body.__doc__
        return test

    return wrap


def _norm_err(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@cases("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@cases("derivative", [False, True])
def test_spline_kernel(dev, dtype, tol, derivative):
    g = torch.Generator(device=dev).manual_seed(0)
    series = torch.randn(3, 5, 50, 3, generator=g, device=dev, dtype=dtype)
    t = torch.arange(50, dtype=dtype, device=dev)
    q = torch.tensor([0.0, 2.5, 47.9, 48.2, 49.0, -2.0, 60.0], dtype=dtype, device=dev)
    before = _build.LAUNCHES["spline"]
    got = spline.gather_eval_kernel(series, t, q, derivative)
    assert _build.LAUNCHES["spline"] == before + 1
    assert _norm_err(got, spline.gather_eval_plain(series, t, q, derivative)) <= tol


# D=64 and D=128 take the tensor-core kernel (3xTF32, node tiles of 64 with
# an online softmax; N within one tile, across tiles, at SYNTH's N=16 and at
# the HZME, PEMS08, PEMS04, PEMS03 and PEMS07 sizes; more work items than
# SMs, so that a CTA walks several): within 1e-5 of the float64 plain
# version and the same bits twice. Other D take the generic kernel, held at
# 1e-4 against the float32 plain version.
@cases("shape", [(2, 17, 3, 32), (1, 45, 2, 128), (2, 100, 2, 128),
                                   (1, 170, 3, 128), (1, 200, 1, 128), (1, 307, 2, 128),
                                   (1, 358, 2, 128), (1, 883, 1, 128), (2, 33, 1, 256),
                                   (2, 80, 3, 128), (4, 100, 20, 128), (2, 16, 12, 64),
                                   (1, 170, 3, 64), (3, 70, 40, 64)])
def test_gcn_kernel(dev, shape):
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(*shape, generator=g, device=dev)
    gate = torch.rand(shape[1], shape[1], generator=g, device=dev)
    before = _build.LAUNCHES["gcn_fwd"]
    (got,) = _bitwise_twice(lambda: (gcn.gcn_spatial_mix_kernel(x, gate, 0.3),))
    assert _build.LAUNCHES["gcn_fwd"] == before + 2
    if shape[-1] in (64, 128):
        want = gcn.gcn_spatial_mix_plain(x.double(), gate.double(), 0.3, dtype_name="float64")
        assert _norm_err(got.double(), want) <= 1e-5
    else:
        assert _norm_err(got, gcn.gcn_spatial_mix_plain(x, gate, 0.3)) <= 1e-4


def test_gcn_kernel_refuses_a_slice_beyond_shared_memory(dev):
    x = torch.zeros(1, 300, 1, 256, device=dev)  # the generic kernel stages whole slices
    with pytest.raises(ValueError, match="shared memory"):
        gcn.gcn_spatial_mix_kernel(x, torch.zeros(300, 300, device=dev))


# D3STN's three flag sets at its shapes (D = 128 / 8 heads, D = 64 / 4
# heads) take the tensor-core kernel (tiles of 8 rows: B*N = 10, 37 and 340
# leave a ragged last tile; SYNTH's 32 x 16 rows fill 64 tiles); the fourth
# set and the other shapes the generic one
@cases("flags", [(False, False, False), (True, True, True), (True, False, False),
                                   (False, True, False)])
@cases("b,n,tq,tk,d,heads", [(2, 5, 12, 12, 128, 8), (1, 37, 12, 12, 128, 8),
                                                (2, 170, 12, 12, 128, 8), (1, 7, 9, 9, 64, 4),
                                                (2, 3, 16, 16, 32, 2), (32, 16, 12, 12, 64, 4),
                                                (1, 37, 12, 12, 64, 4)])
def test_attention_kernel(dev, flags, b, n, tq, tk, d, heads):
    g = torch.Generator(device=dev).manual_seed(2)
    r = lambda *s: torch.randn(*s, generator=g, device=dev)
    arrays = [r(b, n, tq, d), r(b, n, tk, d), r(b, n, tk, d)]
    for _ in range(4):
        arrays += [r(3, d, d) / d ** 0.5, 0.1 * r(d)]
    before = _build.LAUNCHES["attn_fwd"]
    got = attn.fused_temporal_attention_kernel(*arrays, *flags, heads)
    assert _build.LAUNCHES["attn_fwd"] == before + 1
    d3stn = (tq == tk == 12 and d in (64, 128) and heads == d // 16
             and flags != (False, True, False))
    assert attn.f32_fwd_route(*arrays[:2], arrays[3], *flags, heads) == (
        "d3stn" if d3stn else "generic")
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
@cases("shape", [(2, 17, 3, 64), (1, 16, 12, 64), (2, 45, 2, 128),
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
@cases("flags", [(False, False, False), (True, True, True), (True, False, False)])
@cases("b,n,d,heads", [(2, 5, 128, 8), (1, 7, 64, 4), (3, 11, 128, 8),
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


def _bf16_close(got, want):
    """Within one bfloat16 ulp at the top binade, on at most 1% of elements."""
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    err, ulp, share = bf16_errors(got, want)
    assert err <= ulp and share <= 0.01, (err, ulp, share)


# the bfloat16 K2 (csrc/gcn_bf16.cu): N within one node tile, across tiles
# (HZME's 80, PEMS08's 170: the slice kernel, every node tile resident) and
# past 3 tiles (200, PEMS04's 307, PEMS03's 358, PEMS07's 883: two passes),
# the slice kernel's edges (an exact tile 64, a ragged one 65, the resident
# limit 192 and one past it, 193), its persistent walk with fewer slices
# than SMs (B T = 6) and several slices a CTA (B T = 384 at N = 170, 480 at
# 100, 768 at 16 with three CTAs an SM), D = 64 and 128, x float32 (as
# D3STN passes it) and bfloat16; against the plain bfloat16 version on the
# card, the same bits twice
@cases("x_dtype", [torch.float32, torch.bfloat16])
@cases("shape", [(2, 16, 12, 64), (2, 16, 3, 128), (2, 80, 3, 64),
                                   (2, 80, 3, 128), (1, 170, 3, 64), (2, 170, 3, 128),
                                   (1, 200, 2, 64), (1, 307, 2, 128), (2, 64, 3, 128),
                                   (2, 65, 3, 64), (2, 192, 3, 128), (1, 193, 2, 128),
                                   (1, 358, 2, 128), (1, 883, 1, 128), (32, 170, 12, 128),
                                   (40, 100, 12, 64), (64, 16, 12, 64)])
def test_gcn_bf16_kernel(dev, shape, x_dtype):
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(*shape, generator=g, device=dev).to(x_dtype)
    gate = torch.rand(shape[1], shape[1], generator=g, device=dev)
    scale2 = shape[-1] ** -0.5
    before = _build.LAUNCHES["gcn_fwd_bf16"]
    (got,) = _bitwise_twice(lambda: (gcn.gcn_spatial_mix_bf16_kernel(x, gate, scale2),))
    assert _build.LAUNCHES["gcn_fwd_bf16"] == before + 2
    _bf16_close(got, gcn.gcn_spatial_mix_plain(x, gate, scale2, "bfloat16"))
    # the routed function serves through the same kernel
    with torch.no_grad():
        assert torch.equal(gcn.gcn_spatial_mix(x, gate, scale2, "bfloat16"), got)


def test_gcn_bf16_kernel_refuses_other_widths(dev):
    x = torch.zeros(1, 5, 2, 32, device=dev)
    with pytest.raises(ValueError, match="gcn_impl"):
        gcn.gcn_spatial_mix_bf16_kernel(x, torch.zeros(5, 5, device=dev))


# the bfloat16 K4 (csrc/attn_bf16.cu): B*N = 37 and 921 (a ragged last tile
# of 16 rows), 340, and 14128 (883 tiles: several waves of CTAs over the SMs),
# D = 128 with 8 heads and 64 with 4, D3STN's three flag sets
@cases("flags", [(False, False, False), (True, True, True), (True, False, False)])
@cases("b,n,d,heads", [(1, 37, 128, 8), (1, 37, 64, 4), (2, 170, 128, 8),
                                         (2, 170, 64, 4), (3, 307, 128, 8), (16, 883, 128, 8),
                                         (16, 883, 64, 4)])
def test_attention_bf16_kernel(dev, flags, b, n, d, heads):
    g = torch.Generator(device=dev).manual_seed(7)
    r = lambda *s: torch.randn(*s, generator=g, device=dev)
    arrays = [r(b, n, 12, d), r(b, n, 12, d), r(b, n, 12, d)]
    for _ in range(4):
        arrays += [r(3, d, d) / d ** 0.5, 0.1 * r(d)]
    before = _build.LAUNCHES["attn_fwd_bf16"]
    (got,) = _bitwise_twice(lambda: (attn.fused_temporal_attention_bf16_kernel(*arrays, *flags,
                                                                               heads),))
    assert _build.LAUNCHES["attn_fwd_bf16"] == before + 2
    _bf16_close(got, attn.fused_temporal_attention_plain(*arrays, *flags, heads, "bfloat16"))
    with torch.no_grad():
        assert torch.equal(attn.fused_temporal_attention(*arrays, *flags, heads, "bfloat16"), got)


@cases("d,heads,t_len,flags", [(32, 2, 12, (False, False, False)),
                                                 (128, 4, 12, (False, False, False)),
                                                 (128, 8, 9, (False, False, False)),
                                                 (128, 8, 12, (False, True, False))])
def test_attention_bf16_kernel_refuses_other_shapes(dev, d, heads, t_len, flags):
    arrays = [torch.zeros(1, 3, t_len, d, device=dev) for _ in range(3)]
    for _ in range(4):
        arrays += [torch.zeros(3, d, d, device=dev), torch.zeros(d, device=dev)]
    with pytest.raises(ValueError, match="attn_impl"):
        attn.fused_temporal_attention_bf16_kernel(*arrays, *flags, heads)


@cases("d_in,bias", [(1, True), (128, False)])
def test_bf16_dense_sums_in_float32_whatever_the_flag(dev, d_in, bias):
    """The bfloat16 dense layer gives the same bits with cuBLAS's
    reduced-precision flag on and off, within one bfloat16 ulp of the CPU's
    float32 sums on at most 1% of elements."""
    from paddlexde_tpu_torch.models.d3stn.model import _dense

    g = torch.Generator().manual_seed(d_in)
    layer = torch.nn.Linear(d_in, 128, bias=bias)
    with torch.no_grad():
        layer.weight.normal_(generator=g)
        if bias:
            layer.bias.normal_(generator=g)
    x = torch.randn(4, 170, 12, d_in, generator=g)
    want = _dense(x, layer, True)
    layer = layer.to(dev)
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    try:
        got = []
        for on in (True, False):
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = on
            got.append(_dense(x.to(dev), layer, True))
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
    assert got[0].dtype == torch.bfloat16 and torch.equal(got[0], got[1])
    err, ulp, share = bf16_errors(got[0], want)
    assert err <= ulp and share <= 0.01, (err, ulp, share)


# the bfloat16 K5 (csrc/attn_bwd_bf16.cu), D = 128 with 8 heads and 64 with
# 4, D3STN's three flag sets, at the edges of the persistent conv kernel's
# 16-row tiles (attn.bf16_conv_ctas), the core's 4 rows and the
# weight-gradient kernel's 8-row tiles and splits (attn.bf16_dw_splits, one
# wave of CTAs; on an H100 with 132 SMs): B*N = 5 (fewer rows than one
# tile), 37 (5 splits of one tile, the last ragged), 340 (43 tiles in 15
# splits of 3 at D = 128: the last split one tile of 4 rows; conv CTAs of
# 2 or 3 tiles), 400 (25 conv tiles: fewer than the SMs per job, one tile a
# CTA), 921 (116 tiles in 29 splits of 4 at D = 64, the last tile one row),
# 14128 (111 tiles a CTA at D = 128, 54 at D = 64; 27 conv tiles a CTA in
# the 4-job launch, 21 in the 3-job one) and 340 at D = 64 (22 splits of
# 2, the last tile 4 rows); against the plain bfloat16 backward on the card
# by attn.bwd_errors (limit as chip_smoke.py's), the same bits twice
@cases("flags", [(False, False, False), (True, True, True), (True, False, False)])
@cases("b,n,d,heads", [(1, 5, 128, 8), (1, 5, 64, 4), (1, 37, 128, 8),
                                         (1, 37, 64, 4), (2, 170, 128, 8), (2, 170, 64, 4),
                                         (2, 200, 128, 8), (3, 307, 64, 4), (16, 883, 128, 8),
                                         (16, 883, 64, 4)])
def test_attention_bwd_bf16_kernel(dev, flags, b, n, d, heads):
    g = torch.Generator(device=dev).manual_seed(8)
    r = lambda *s: torch.randn(*s, generator=g, device=dev)
    arrays = [r(b, n, 12, d), r(b, n, 12, d), r(b, n, 12, d)]
    for _ in range(4):
        arrays += [r(3, d, d) / d ** 0.5, 0.1 * r(d)]
    cot = r(b, n, 12, d).to(torch.bfloat16)
    before = _build.LAUNCHES["attn_bwd_bf16"]
    got = _bitwise_twice(lambda: attn.fused_temporal_attention_bwd_bf16_kernel(*arrays, cot, *flags,
                                                                               heads))
    assert _build.LAUNCHES["attn_bwd_bf16"] == before + 2
    want = attn.fused_temporal_attention_bwd_plain(*arrays, cot, *flags, heads, "bfloat16")
    for a, w in zip(got, want):
        assert a.shape == w.shape and a.dtype == w.dtype
    assert max(attn.bwd_errors(got, want)) <= 2e-3


def test_attention_bwd_bf16_kernel_takes_bf16_activations(dev):
    """bfloat16 mq, mk, vs give bfloat16 input gradients, within one ulp of
    the plain version's on at most 1% of elements."""
    g = torch.Generator(device=dev).manual_seed(9)
    r = lambda *s: torch.randn(*s, generator=g, device=dev)
    arrays = [r(1, 37, 12, 64).to(torch.bfloat16) for _ in range(3)]
    for _ in range(4):
        arrays += [r(3, 64, 64) / 8, 0.1 * r(64)]
    cot = r(1, 37, 12, 64).to(torch.bfloat16)
    got = attn.fused_temporal_attention_bwd_bf16_kernel(*arrays, cot, False, False, False, 4)
    want = attn.fused_temporal_attention_bwd_plain(*arrays, cot, False, False, False, 4,
                                                   "bfloat16")
    for a, w in zip(got[:3], want[:3]):
        _bf16_close(a, w)
    assert max(attn.bwd_errors(got, want)[3:]) <= 2e-3


@cases("d,heads,t_len,flags", [(32, 2, 12, (False, False, False)),
                                                 (128, 4, 12, (False, False, False)),
                                                 (128, 8, 9, (False, False, False)),
                                                 (128, 8, 12, (False, True, False))])
def test_attention_bwd_bf16_kernel_refuses_other_shapes(dev, d, heads, t_len, flags):
    arrays = [torch.zeros(1, 3, t_len, d, device=dev) for _ in range(3)]
    for _ in range(4):
        arrays += [torch.zeros(3, d, d, device=dev), torch.zeros(d, device=dev)]
    cot = torch.zeros(1, 3, t_len, d, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="attn_impl"):
        attn.fused_temporal_attention_bwd_bf16_kernel(*arrays, cot, *flags, heads)
    leaves = [a.requires_grad_() for a in arrays]
    with pytest.raises(ValueError, match="attn_impl"):
        attn.fused_temporal_attention(*leaves, *flags, heads, "bfloat16")


# K3 on a bfloat16 cotangent: the float32 kernel on g.float(), bit for bit,
# x float32 and bfloat16
@cases("x_dtype", [torch.float32, torch.bfloat16])
@cases("shape", [(2, 17, 3, 64), (1, 170, 3, 128), (2, 80, 3, 128)])
def test_gcn_bwd_kernel_on_bf16_cotangent(dev, shape, x_dtype):
    g = torch.Generator(device=dev).manual_seed(10)
    x = torch.randn(*shape, generator=g, device=dev).to(x_dtype)
    gate = torch.rand(shape[1], shape[1], generator=g, device=dev)
    cot = torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)
    before = dict(_build.LAUNCHES)
    dx, dgate = gcn.gcn_spatial_mix_bwd_bf16_kernel(x, gate, cot, 0.3)
    assert _build.LAUNCHES["gcn_bwd_bf16"] == before["gcn_bwd_bf16"] + 1
    assert _build.LAUNCHES["gcn_bwd"] == before["gcn_bwd"]
    want = gcn.gcn_spatial_mix_bwd_kernel(x.float(), gate, cot.float(), 0.3)
    assert dx.dtype == x_dtype and torch.equal(dx, want[0].to(x_dtype))
    assert torch.equal(dgate, want[1])


def test_bf16_autograd_through_the_kernels(dev):
    """Gradients of the bfloat16 kernel path against the plain bfloat16 path
    (impl="xla") on the card, with ``mk is mq``: the GCN's bit for bit but
    for the kernels' float32 sum orders, the attention's by attn.bwd_errors."""
    g = torch.Generator(device=dev).manual_seed(11)
    r = lambda *s: torch.randn(*s, generator=g, device=dev)
    x = r(2, 9, 12, 64).requires_grad_()
    gate = torch.rand(9, 9, generator=g, device=dev).requires_grad_()
    weights = [p.requires_grad_() for _ in range(4) for p in (r(3, 64, 64) / 8, 0.1 * r(64))]
    grads, launches = [], []
    for impl in ("pallas", "xla"):
        _build.reset_launches()
        y = gcn.gcn_spatial_mix(x, gate, 0.125, "bfloat16", impl=impl).float()
        y = attn.fused_temporal_attention(y, y, x, *weights, False, False, False, 4, "bfloat16",
                                          impl=impl).float()
        grads.append(torch.autograd.grad((y * y).sum(), [x, gate, *weights]))
        launches.append(dict(_build.LAUNCHES))
    assert launches[0]["gcn_bwd_bf16"] == 1 and launches[0]["attn_bwd_bf16"] == 1
    assert launches[1]["gcn_bwd_bf16"] == 0 and launches[1]["attn_bwd_bf16"] == 0
    (dx, dgate, *dw), (dx_ref, dgate_ref, *dw_ref) = grads
    assert _norm_err(dgate, dgate_ref) <= 1e-2
    assert max(attn.bwd_errors([dx] * 3 + dw, [dx_ref] * 3 + dw_ref)) <= 1e-2


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


def _keep_mask(g, dev, b, n, heads, rate=0.1):
    """A pre-scaled keep mask [b, n, 12, heads * 12]: {0, 1/keep}."""
    keep = 1.0 - rate
    return (torch.rand(b, n, 12, heads * 12, generator=g, device=dev) < keep).float() / keep


# the dropout forms of K4 and K5 (csrc/attn.cu, attn_bwd.cu, attn_bf16.cu,
# attn_bwd_bf16.cu): ragged tiles (B*N = 37; 921 rows, not a multiple of
# 16), several weight-gradient splits (340 rows; 921 rows: K5 bf16's 116
# tiles in 15 splits of 8, the last split 4 tiles, its last tile one row),
# 14128 rows (883 tiles of 16: several waves, and many tiles a persistent
# conv CTA), D = 128 and 64 (SYNTH's 32 x 16 rows at D = 64); against the
# plain versions with the same mask on the card, the same bits twice, and
# an all-keep mask giving the no-dropout kernel's bits
@cases("dtype_name", ["float32", "bfloat16"])
@cases("flags", [(False, False, False), (True, True, True), (True, False, False)])
@cases("b,n,d,heads", [(1, 37, 128, 8), (2, 170, 128, 8), (1, 37, 64, 4),
                                         (3, 307, 128, 8), (32, 16, 64, 4), (16, 883, 128, 8),
                                         (16, 883, 64, 4)])
def test_attention_dropout_kernels(dev, dtype_name, flags, b, n, d, heads):
    g = torch.Generator(device=dev).manual_seed(12)
    r = lambda *s: torch.randn(*s, generator=g, device=dev)
    arrays = [r(b, n, 12, d), r(b, n, 12, d), r(b, n, 12, d)]
    for _ in range(4):
        arrays += [r(3, d, d) / d ** 0.5, 0.1 * r(d)]
    cot = r(b, n, 12, d)
    mask = _keep_mask(g, dev, b, n, heads)
    ones = torch.ones_like(mask)
    bf16 = dtype_name == "bfloat16"
    fwd = attn.fused_temporal_attention_bf16_kernel if bf16 else attn.fused_temporal_attention_kernel
    bwd = (attn.fused_temporal_attention_bwd_bf16_kernel if bf16
           else attn.fused_temporal_attention_bwd_kernel)
    if bf16:
        cot = cot.to(torch.bfloat16)
    suffix = "_bf16" if bf16 else ""
    before = dict(_build.LAUNCHES)
    (y,) = _bitwise_twice(lambda: (fwd(*arrays, *flags, heads, dropout_mask=mask),))
    assert _build.LAUNCHES[f"attn_fwd{suffix}_dropout"] == before[f"attn_fwd{suffix}_dropout"] + 2
    want = attn.fused_temporal_attention_plain(*arrays, *flags, heads, dtype_name, mask)
    if bf16:
        _bf16_close(y, want)
    else:
        assert _norm_err(y, want) <= 1e-4
        want64 = attn.fused_temporal_attention_plain(*[a.double() for a in arrays], *flags,
                                                     heads, "float64", mask)
        assert _norm_err(y.double(), want64) <= 1e-5
    assert torch.equal(fwd(*arrays, *flags, heads, dropout_mask=ones),
                       fwd(*arrays, *flags, heads))
    got = _bitwise_twice(lambda: bwd(*arrays, cot, *flags, heads, dropout_mask=mask))
    assert _build.LAUNCHES[f"attn_bwd{suffix}_dropout"] == before[f"attn_bwd{suffix}_dropout"] + 2
    if bf16:
        want = attn.fused_temporal_attention_bwd_plain(*arrays, cot, *flags, heads, "bfloat16",
                                                       mask)
        assert max(attn.bwd_errors(got, want)) <= 2e-3
    else:
        want = attn.fused_temporal_attention_bwd_plain(*[a.double() for a in arrays],
                                                       cot.double(), *flags, heads, "float64",
                                                       mask)
        assert max(attn.bwd_errors(got, want)) <= 1e-5
    no_drop = bwd(*arrays, cot, *flags, heads)
    assert all(torch.equal(a, w) for a, w in
               zip(bwd(*arrays, cot, *flags, heads, dropout_mask=ones), no_drop))


@cases("dtype_name", ["float32", "bfloat16"])
def test_autograd_through_the_dropout_kernels(dev, dtype_name):
    """Gradients of the dropout kernels against the plain dropout path
    (impl="xla") on the card, with ``mk is mq``; the mask gets None."""
    g = torch.Generator(device=dev).manual_seed(13)
    r = lambda *s: torch.randn(*s, generator=g, device=dev)
    x = r(2, 9, 12, 128).requires_grad_()
    weights = [p.requires_grad_() for _ in range(4) for p in (r(3, 128, 128) / 11.3, 0.1 * r(128))]
    mask = _keep_mask(g, dev, 2, 9, 8, rate=0.3).requires_grad_()
    grads, launches = [], []
    for impl in ("pallas", "xla"):
        _build.reset_launches()
        y = attn.fused_temporal_attention_dropout(x, x, x, *weights, mask, False, False, False,
                                                  8, dtype_name, impl=impl).float()
        *got, dmask = torch.autograd.grad((y * y).sum(), [x, *weights, mask], allow_unused=True)
        assert dmask is None
        grads.append(got)
        launches.append(dict(_build.LAUNCHES))
    suffix = "_bf16" if dtype_name == "bfloat16" else ""
    assert launches[0][f"attn_fwd{suffix}_dropout"] == 1
    assert launches[0][f"attn_bwd{suffix}_dropout"] == 1
    assert sum(launches[1].values()) == 0
    (dx, *dw), (dx_ref, *dw_ref) = grads
    tol = 1e-2 if dtype_name == "bfloat16" else 1e-4
    assert max(attn.bwd_errors([dx] * 3 + dw, [dx_ref] * 3 + dw_ref)) <= tol
