"""Read the JAX Trainer's optimizer sidecar (``epoch_*.params.opt``) without JAX.

``paddlexde_tpu/models/d3stn/trainer.py:699-723`` (``save(full_state=True)``)
pickles ``{"opt_state", "finetune", "kl_loss_weight", "epoch"}``, where
``opt_state`` is the state of ``optax.chain(add_decayed_weights | identity,
scale_by_adam())`` (``:213-216``) over ``{"net": flax tree, "enc_idx",
"dec_idx"}`` with every leaf a numpy array: a tuple of an ``EmptyState``
(either first transform) and a ``ScaleByAdamState(count, mu, nu)``. The
pickle names two optax classes and numpy's reconstructors and nothing else.

:class:`SidecarUnpickler` maps the two optax classes to plain named tuples,
allows numpy's reconstructors and refuses every other global, so reading a
sidecar imports neither optax nor JAX and runs no code the file names.
:func:`read_jax_sidecar` turns the Adam moments into the port Trainer's flat
vectors in its ``state_names`` order, by name, through the same flattening
as :func:`~.weights.load_flax_params`, never by leaf order.
"""

from __future__ import annotations

import collections
import pickle
from typing import Dict, Sequence

import numpy as np

from .weights import _flax_to_state_dict

__all__ = ["EmptyState", "ScaleByAdamState", "SidecarUnpickler", "read_jax_sidecar"]

EmptyState = collections.namedtuple("EmptyState", [])
ScaleByAdamState = collections.namedtuple("ScaleByAdamState", ["count", "mu", "nu"])

_OPTAX = {
    ("optax._src.base", "EmptyState"): EmptyState,
    ("optax._src.transform", "ScaleByAdamState"): ScaleByAdamState,
}
# numpy's array, dtype and scalar reconstructors (numpy 2 under ``_core``,
# numpy 1 under ``core``)
_NUMPY = {"_reconstruct", "scalar", "_frombuffer", "ndarray", "dtype"}
_NUMPY_MODULES = {"numpy", "numpy.core.multiarray", "numpy._core.multiarray",
                  "numpy.core.numeric", "numpy._core.numeric"}


class SidecarUnpickler(pickle.Unpickler):
    """An unpickler that knows the two optax state classes and numpy's
    reconstructors, and raises ``pickle.UnpicklingError`` naming any other
    global."""

    def find_class(self, module, name):
        if (module, name) in _OPTAX:
            return _OPTAX[(module, name)]
        if module in _NUMPY_MODULES and name in _NUMPY:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"the optimizer sidecar names the global {module}.{name}, which is "
            "neither optax's EmptyState or ScaleByAdamState nor a numpy reconstructor"
        )


def _flat(tree, names: Sequence[str], sizes: Sequence[int]) -> np.ndarray:
    """A moment tree ``{"net", "enc_idx", "dec_idx"}`` as one float32 vector
    in ``names`` order."""
    by_name = _flax_to_state_dict(tree["net"])
    by_name["enc_idx"] = np.asarray(tree["enc_idx"])
    by_name["dec_idx"] = np.asarray(tree["dec_idx"])
    missing = sorted(set(names) - set(by_name))
    unexpected = sorted(set(by_name) - set(names))
    if missing or unexpected:
        raise KeyError(f"the sidecar's moments do not match the model: missing {missing}, "
                       f"unexpected {unexpected}")
    parts = []
    for name, size in zip(names, sizes):
        value = np.asarray(by_name[name], np.float32).reshape(-1)
        if value.size != size:
            raise ValueError(f"{name}: the sidecar holds {value.size} values, the model {size}")
        parts.append(value)
    return np.concatenate(parts)


def read_jax_sidecar(path: str, names: Sequence[str], sizes: Sequence[int]) -> Dict:
    """``{"count", "mu", "nu", "finetune", "kl_loss_weight", "epoch"}`` of the
    JAX sidecar at ``path``: ``count`` an int32 array, ``mu``/``nu`` float32
    vectors over the tensors ``names`` (of ``sizes`` elements each), the
    rest as pickled (``epoch`` None when the JAX Trainer recorded none)."""
    with open(path, "rb") as f:
        extra = SidecarUnpickler(f).load()
    adam = [s for s in extra["opt_state"] if isinstance(s, ScaleByAdamState)]
    others = [s for s in extra["opt_state"] if not isinstance(s, (ScaleByAdamState, EmptyState))]
    if len(adam) != 1 or others:
        raise ValueError(f"{path}: expected one EmptyState and one ScaleByAdamState, got "
                         f"{[type(s).__name__ for s in extra['opt_state']]}")
    (adam,) = adam
    return {
        "count": np.asarray(adam.count, np.int32),
        "mu": _flat(adam.mu, names, sizes),
        "nu": _flat(adam.nu, names, sizes),
        "finetune": bool(extra["finetune"]),
        "kl_loss_weight": float(extra["kl_loss_weight"]),
        "epoch": extra.get("epoch"),
    }
