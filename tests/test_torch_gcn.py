"""GCN kernel K2's plain version against the JAX ``gcn_spatial_mix``
reference (``use_pallas=False``), float32, to 1e-5 normalised max-abs error
(summation order differs between the two frameworks' float32 einsums)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlexde_tpu.ops.gcn_pallas import gcn_spatial_mix as jax_gcn
from paddlexde_tpu_torch.ops import gcn


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


def _norm_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("shape,scale2", [
    ((2, 6, 3, 32), 1.0),
    ((2, 7, 4, 16), 0.25),
    ((1, 17, 12, 64), 1.0 / 8.0),
])
def test_plain_matches_jax(shape, scale2):
    rng = np.random.RandomState(sum(shape))
    x = rng.randn(*shape).astype(np.float32)
    gate = (0.5 * rng.rand(shape[1], shape[1])).astype(np.float32)
    want = jax_gcn(jnp.asarray(x), jnp.asarray(gate), scale2, "float32", False)
    got = gcn.gcn_spatial_mix(torch.tensor(x), torch.tensor(gate), scale2)
    assert got.dtype == torch.float32
    assert _norm_err(got.numpy(), want) <= TOL
    # "xla" is the plain version on any device
    same = gcn.gcn_spatial_mix(torch.tensor(x), torch.tensor(gate), scale2, impl="xla")
    assert torch.equal(same, got)


def test_kernel_paths_refuse_cpu_tensors():
    x, gate = torch.zeros(1, 3, 2, 32), torch.zeros(3, 3)
    with pytest.raises(ValueError, match="CUDA"):
        gcn.gcn_spatial_mix(x, gate, impl="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        gcn.gcn_spatial_mix_kernel(x, gate)
    with pytest.raises(ValueError, match="impl"):
        gcn.gcn_spatial_mix(x, gate, impl="triton")


@pytest.mark.parametrize("source", ["gcn.cu", "gcn_bwd.cu"])
def test_gcn_kernels_rebuild_when_their_shared_header_changes(source):
    """K2 and K3 share their tensor-core pieces (csrc/gcn_tc.cuh, which
    includes tc_conv.cuh); each library's build hash covers both."""
    from paddlexde_tpu_torch.ops import _build

    assert _build._headers(source) == ["gcn_tc.cuh", "tc_conv.cuh"]


@pytest.fixture
def _f32_jax():
    """The TPU kernel in interpret mode computes in float32 (as its own tests
    run it); restore the suite's x64 setting afterwards."""
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", before)


@pytest.mark.parametrize("shape,scale2", [((2, 7, 3, 16), 0.25), ((1, 12, 2, 32), 1.0)])
def test_plain_backward_matches_autograd_float64(shape, scale2):
    """K3's plain backward (the kernel's explicit math) against autograd of
    the plain forward, float64, to 1e-12."""
    rng = np.random.RandomState(sum(shape))
    x = torch.tensor(rng.randn(*shape), requires_grad=True)
    gate = torch.tensor(rng.rand(shape[1], shape[1]), requires_grad=True)
    g = torch.tensor(rng.randn(*shape))
    y = gcn.gcn_spatial_mix_plain(x, gate, scale2, "float64")
    want = torch.autograd.grad(y, (x, gate), g)
    got = gcn.gcn_spatial_mix_bwd_plain(x.detach(), gate.detach(), g, scale2)
    for a, w in zip(got, want):
        assert a.dtype == torch.float64
        assert _norm_err(a.numpy(), w.numpy()) <= 1e-12


@pytest.mark.parametrize("shape,scale2", [((2, 7, 3, 16), 0.25), ((3, 10, 2, 32), 1.0)])
def test_plain_backward_matches_jax_tpu_kernel(_f32_jax, shape, scale2):
    """K3's plain backward against ``jax.vjp`` of the TPU kernel
    (``_bwd_kernel`` in interpret mode), float32, to 1e-5 normalised."""
    rng = np.random.RandomState(7 + sum(shape))
    x = rng.randn(*shape).astype(np.float32)
    gate = rng.rand(shape[1], shape[1]).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jax_gcn(a, b, scale2, "float32", True, True, False),
                     jnp.asarray(x), jnp.asarray(gate))
    want = vjp(jnp.asarray(g))
    got = gcn.gcn_spatial_mix_bwd_plain(torch.tensor(x), torch.tensor(gate), torch.tensor(g),
                                        scale2)
    for a, w in zip(got, want):
        assert a.dtype == torch.float32
        assert _norm_err(a.numpy(), w) <= TOL
