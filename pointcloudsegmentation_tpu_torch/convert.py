"""Flax parameter tree -> the port's ``state_dict``.

Submodules keep the flax names, so a flax path maps to a torch key one to
one: ``params/encoder/feats0/fc_0_nbr/kernel`` becomes
``encoder.feats0.fc_0_nbr.weight``.  Flax ``Dense`` kernels are [in, out];
torch ``Linear`` weights are [out, in], so kernels are transposed."""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

_LEAF = {"kernel": "weight", "bias": "bias"}


def _flatten(tree: Mapping, prefix=()):
    for name, sub in tree.items():
        path = prefix + (str(name),)
        if isinstance(sub, Mapping):
            yield from _flatten(sub, path)
        else:
            yield path, sub


def flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Nested mapping of numpy arrays (with or without the top-level
    ``params`` collection) -> {torch key: float32 tensor}.  Raises on a leaf
    that is not a Dense kernel or bias."""
    if set(params) == {"params"}:
        params = params["params"]
    out = {}
    for path, leaf in _flatten(params):
        if path[-1] not in _LEAF:
            raise KeyError(f"unmapped flax leaf {'/'.join(path)}")
        arr = np.asarray(leaf, np.float32)
        if path[-1] == "kernel":
            if arr.ndim != 2:
                raise ValueError(f"{'/'.join(path)}: kernel of shape "
                                 f"{arr.shape} is not a Dense kernel")
            arr = arr.T
        key = ".".join(path[:-1] + (_LEAF[path[-1]],))
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def load_flax_params(model: nn.Module, params: Mapping) -> nn.Module:
    """Load a flax parameter tree into ``model``; raises on any key missing
    or left over on either side, or on a shape mismatch."""
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    return model
