"""GCN kernel K2's plain version against the JAX ``gcn_spatial_mix``
reference (``use_pallas=False``), float32, to 1e-5 normalised max-abs error
(summation order differs between the two frameworks' float32 einsums)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlexde_tpu.ops.gcn_pallas import gcn_spatial_mix as jax_gcn
from paddlexde_tpu_torch.ops import gcn

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
