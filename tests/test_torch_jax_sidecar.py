"""The port's Trainer resumes from the JAX Trainer's optimizer sidecar
(``epoch_*.params.opt``, an optax pickle) without optax or JAX: the Adam
moments equal by name, the step count, the phase, the KL weight and the
resume epoch as the JAX ``load`` sets them; the port's own sidecar keeps
precedence; a pickle naming any other global is refused; and the port's
Adam update from the loaded state is optax's ``scale_by_adam``."""

import collections
import copy
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from paddlexde_tpu_torch.models.d3stn import D3STNConfig, Trainer, to_flax_params
from paddlexde_tpu_torch.models.d3stn.trainer import scale_by_adam


@pytest.fixture(autouse=True)
def _f32_jax():
    """The JAX Trainer's optimizer state is float32 (x64 off); restore the
    suite's x64 setting afterwards."""
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", before)


def _trainer(save_dir):
    cfg = D3STNConfig(num_nodes=4, his_len=16, tgt_len=12, encoder_num_layers=1,
                      decoder_num_layers=1, d_model=16, d_proj=8, d_sect=4, d_adaptive=0,
                      head=2, top_k=2, save_dir=str(save_dir))
    data = np.random.RandomState(0).rand(288, 4, 1).astype(np.float32)
    eye = np.eye(4, dtype=np.float32)
    return Trainer(cfg, data=data, adj_matrix=eye, sc_matrix=eye, device="cpu")


def _tree(trainer, flat):
    """A flat vector in ``state_names`` order as the JAX Trainer's optimizer
    tree ``{"net", "enc_idx", "dec_idx"}``, through ``to_flax_params`` (the
    inverse of the mapping under test)."""
    parts = flat.detach().split(trainer._sizes)
    model = copy.deepcopy(trainer.model)
    with torch.no_grad():
        for p, v in zip(model.parameters(), parts[:-2]):
            p.copy_(v.view_as(p))
    return {"net": to_flax_params(model), "enc_idx": parts[-2].numpy(),
            "dec_idx": parts[-1].numpy()}


def _assert_trees_equal(got, want, rtol=0.0):
    jax.tree.map(lambda g, w: np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                                         rtol=rtol, atol=0), got, want)


def test_trainer_resumes_from_the_jax_sidecar(tmp_path):
    rng = np.random.RandomState(0)
    for i, tx in enumerate((optax.chain(optax.identity(), optax.scale_by_adam()),
                            optax.chain(optax.add_decayed_weights(1e-4), optax.scale_by_adam()))):
        writer = _trainer(tmp_path / f"chain{i}")
        total = sum(writer._sizes)
        mu_tree = _tree(writer, torch.tensor(rng.randn(total).astype(np.float32)))
        nu_tree = _tree(writer, torch.tensor(rng.rand(total).astype(np.float32) + 0.1))
        state = tx.init(jax.tree.map(jnp.asarray, mu_tree))
        assert isinstance(state[0], optax.EmptyState)
        state = (state[0], optax.ScaleByAdamState(count=jnp.asarray(7, jnp.int32),
                                                  mu=jax.tree.map(jnp.asarray, mu_tree),
                                                  nu=jax.tree.map(jnp.asarray, nu_tree)))
        # the JAX Trainer's save(epoch=3, full_state=True) layout
        writer.save(epoch=3)
        pf = writer._ckpt_files(3)[0]
        with open(pf + ".opt", "wb") as f:
            pickle.dump({"opt_state": jax.tree.map(np.asarray, state), "finetune": True,
                         "kl_loss_weight": 0.25, "epoch": 3}, f)

        tr = _trainer(tmp_path / f"chain{i}")
        tr.load(epoch=3)
        assert tr.opt_state["count"].dtype == torch.int32 and int(tr.opt_state["count"]) == 7
        assert tr.finetune is True and tr.kl_loss_weight == 0.25 and tr.resume_epoch == 4
        _assert_trees_equal(_tree(tr, tr.opt_state["mu"]), mu_tree)
        _assert_trees_equal(_tree(tr, tr.opt_state["nu"]), nu_tree)

        # the port's Adam update from the loaded state is optax's
        u = torch.tensor(rng.randn(total).astype(np.float32))
        direction, count, mu, nu = scale_by_adam(u, tr.opt_state["count"], tr.opt_state["mu"],
                                                 tr.opt_state["nu"])
        updates, new = optax.scale_by_adam().update(jax.tree.map(jnp.asarray, _tree(tr, u)),
                                                    state[1])
        assert int(count) == int(new.count) == 8
        _assert_trees_equal(_tree(tr, mu), new.mu, rtol=1e-6)
        _assert_trees_equal(_tree(tr, nu), new.nu, rtol=1e-6)
        _assert_trees_equal(_tree(tr, direction), updates, rtol=1e-5)

        # the port's own sidecar keeps precedence over the JAX one
        tr.save(epoch=3, full_state=True)
        with open(pf + ".opt", "wb") as f:
            pickle.dump({"opt_state": jax.tree.map(np.asarray, state), "finetune": False,
                         "kl_loss_weight": 0.5, "epoch": 8}, f)
        again = _trainer(tmp_path / f"chain{i}")
        again.load(epoch=3)
        assert again.kl_loss_weight == 0.25 and again.resume_epoch == 4

    # a pickle that names any other global is refused, naming it
    with open(pf + ".opt", "wb") as f:
        pickle.dump({"opt_state": collections.OrderedDict(), "finetune": False,
                     "kl_loss_weight": 0.0, "epoch": 1}, f)
    os.remove(pf + ".torch_opt.npz")
    with pytest.raises(pickle.UnpicklingError, match="collections.OrderedDict"):
        _trainer(tmp_path / "chain1").load(epoch=3)
