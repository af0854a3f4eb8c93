"""Load a JAX (flax) D3STN parameter tree into the port's modules.

The flax tree is nested dicts of arrays (numpy, or anything ``np.asarray``
takes), as the JAX Trainer pickles it; an outer ``{"params": ...}`` wrapper
is accepted. The port's module tree mirrors the flax names, so the mapping
is mechanical:

- ``.../Conv_0/kernel [1, K, D_in, D_out]`` -> ``.../kernel [K, D_in, D_out]``
  and ``.../Conv_0/bias`` -> ``.../bias``;
- a 2-D ``kernel [in, out]`` (flax ``Dense``) -> ``weight [out, in]``;
- ``Dense_0`` -> ``proj``, ``LayerNorm_0`` -> ``norm``, ``Embed_0`` ->
  ``embed``; ``scale`` -> ``weight``; ``Embed_0/embedding`` -> ``embed.weight``.

Every parameter of the module must be set exactly once and with the right
shape, or the load raises.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["load_flax_params"]

_MODULE_RENAMES = {"Conv_0": None, "Dense_0": "proj", "LayerNorm_0": "norm", "Embed_0": "embed"}


def _flatten(tree: Mapping, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), value


def _flax_to_state_dict(params: Mapping) -> dict:
    """The flax tree as ``{torch parameter name: numpy array}``."""
    if set(params) == {"params"}:
        params = params["params"]
    out = {}
    for path, value in _flatten(params):
        value = np.asarray(value)
        *mods, leaf = path
        embed = bool(mods) and mods[-1] == "Embed_0"
        mods = [_MODULE_RENAMES.get(m, m) for m in mods]
        mods = [m for m in mods if m is not None]
        if leaf == "kernel" and value.ndim == 4:
            value = value[0]
        elif leaf == "kernel" and value.ndim == 2:
            leaf, value = "weight", value.T
        elif leaf == "scale" or (leaf == "embedding" and embed):
            leaf = "weight"
        out[".".join(mods + [leaf])] = value
    return out


def load_flax_params(model: nn.Module, params: Mapping) -> nn.Module:
    """Copy a flax D3STN parameter tree into ``model`` (in place)."""
    arrays = _flax_to_state_dict(params)
    named = dict(model.named_parameters())
    missing = sorted(set(named) - set(arrays))
    unexpected = sorted(set(arrays) - set(named))
    if missing or unexpected:
        raise KeyError(
            f"flax tree does not match the model: missing {missing}, "
            f"unexpected {unexpected}"
        )
    with torch.no_grad():
        for name, param in named.items():
            value = arrays[name]
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(
                    f"{name}: flax shape {tuple(value.shape)} != port shape "
                    f"{tuple(param.shape)}"
                )
            param.copy_(torch.tensor(np.array(value), dtype=param.dtype))
    return model
