"""The port's reference-checkpoint path against the reference model's numpy
spec in ``tests/models/test_d3stn_golden.py`` (``reference_forward``,
``make_reference_state``):

- the port's ``convert_reference_state_dict`` against the JAX package's on
  the same random reference-format state dict: the same flax paths, the
  same arrays, the same unmatched keys (numpy on both sides);
- the port's D3STN against the reference model itself: the spec's state
  dict pushed through the port's ``convert_reference_state_dict`` and
  ``load_flax_params``, within the JAX test's rtol 2e-4 / atol 2e-5 (numpy
  on the reference side, the port's plain versions on the CPU).
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from paddlexde_tpu.models.d3stn import convert_reference_state_dict as jax_convert
from paddlexde_tpu_torch.models.d3stn import (
    D3STN,
    REFERENCE_KEY_RULES,
    convert_reference_state_dict,
    load_config,
    load_flax_params,
    norm_adj_matrix,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch compute thread per worker (the suite runs 6 workers on 8
    cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _golden():
    """``tests/models/test_d3stn_golden.py``, loaded by path under its own
    module name (``tests/`` has no ``__init__.py``)."""
    path = pathlib.Path(__file__).parent / "models" / "test_d3stn_golden.py"
    spec = importlib.util.spec_from_file_location("torch_reference_golden_spec", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield "/".join(prefix + (key,)), value


def test_convert_matches_jax_array_for_array():
    golden = _golden()
    for layers, adaptive in ((1, 4), (2, 0)):
        jax_cfg = golden.golden_cfg(encoder_num_layers=layers, decoder_num_layers=layers,
                                    d_adaptive=adaptive, d_proj=6 + 4 - adaptive)
        cfg = load_config(**{f: getattr(jax_cfg, f) for f in vars(jax_cfg)})
        state = golden.make_reference_state(jax_cfg, np.random.RandomState(layers))
        state["encoder.layers.0.unknown.weight"] = np.ones(3, np.float32)
        got, got_unmatched = convert_reference_state_dict(state, cfg)
        want, want_unmatched = jax_convert(state, jax_cfg)
        assert got_unmatched == want_unmatched == ["encoder.layers.0.unknown.weight"]
        got, want = dict(_leaves(got)), dict(_leaves(want))
        assert sorted(got) == sorted(want)
        for path, value in want.items():
            assert got[path].dtype == value.dtype and got[path].shape == value.shape, path
            np.testing.assert_array_equal(got[path], value, err_msg=path)
        # every rule outside the stacks is used, and the convs are transposed
        assert {ref for ref, _, _ in REFERENCE_KEY_RULES} <= set(state)
        w = state["decoder.layers.0.src_attn.key_conv.weight"]
        np.testing.assert_array_equal(got["dec_0/src_attn/key_conv/Conv_0/kernel"],
                                      np.transpose(w, (2, 3, 1, 0)))


@pytest.mark.parametrize("attention", ["Corr", "Vanilla"])
def test_port_forward_matches_the_reference_spec(attention):
    golden = _golden()
    b, n, t = golden.B, golden.N, golden.T
    jax_cfg = golden.golden_cfg(attention=attention)
    cfg = load_config(**{f: getattr(jax_cfg, f) for f in vars(jax_cfg)})
    # the JAX test's draws, in its order
    rng = np.random.RandomState(42)
    adj = (rng.rand(n, n) < 0.5).astype(np.float32)
    adj = np.maximum(adj, adj.T)
    sc = rng.rand(n, n).astype(np.float32)
    adj_norm = norm_adj_matrix(adj).astype(np.float32)
    sc_norm = norm_adj_matrix(sc).astype(np.float32)
    state = golden.make_reference_state(jax_cfg, rng)
    src = rng.rand(b, n, t, 3).astype(np.float32)
    src[..., 1] = rng.randint(0, 7, (b, n, t))
    src[..., 2] = rng.randint(0, 288, (b, n, t))
    tgt = rng.rand(b, n, t, 3).astype(np.float32)
    tgt[..., 1] = rng.randint(0, 7, (b, n, t))
    tgt[..., 2] = rng.randint(0, 288, (b, n, t))

    want = golden.reference_forward(state, jax_cfg, adj_norm, sc_norm, src, tgt)

    params, unmatched = convert_reference_state_dict(state, cfg)
    assert unmatched == [], unmatched
    model = D3STN(cfg, adj_norm, sc_norm, device="cpu")
    load_flax_params(model, params)  # raises unless the tree covers every parameter
    model.eval()
    with torch.no_grad():
        got = model(torch.tensor(src), torch.tensor(tgt)).numpy()
    assert got.shape == want.shape == (b, n, t, 1)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
