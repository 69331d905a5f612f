"""Flax parameter tree and JAX train state -> the port's ``state_dict`` and
trainer state.

Submodules keep the flax names, so a flax path maps to a torch key one to
one: ``params/encoder/feats0/fc_0_nbr/kernel`` becomes
``encoder.feats0.fc_0_nbr.weight``.  An encoder built with
``fast_conv=False`` has the plain ``PointNetConv``'s ``fc_{i}`` and
``fc_out`` under ``feats{i}``, as the flax tree has; ``remat=True``
(``nn.remat`` in flax, ``torch.utils.checkpoint`` here) renames
nothing.  Flax ``Dense`` kernels are [in, out];
torch ``Linear`` weights are [out, in], so kernels are transposed.  The
other leaves, biases, ``MaskedBatchNorm``'s ``scale``, the ECD convs'
``edge_weights_trans``, the GPN convs' ``pw`` and trainable ``pmiu``,
``ProbsDiffusion``'s ``alpha``, ``AnchorConv``'s ``anchor`` and the
template's trainable anchors (``{conv}_anchor``), keep their names and
flax shapes.

The trainer keeps every parameter in one flat float32 vector laid out as
``jax.flatten_util.ravel_pytree`` lays out the flax tree (``ravel_layout``):
leaves in sorted-path order, each flattened row-major in its flax shape.  So
the JAX trainer's flat Adam moments load as plain copies."""
from __future__ import annotations

from typing import Dict, List, Mapping, NamedTuple, Tuple

import numpy as np
import torch
from torch import nn

# flax leaf -> torch parameter name; only a Dense kernel is transposed
_LEAF = {"kernel": "weight", "bias": "bias", "scale": "scale",
         "edge_weights_trans": "edge_weights_trans", "pw": "pw"}
_FLAX_LEAF = {v: k for k, v in _LEAF.items()}


def _kept(name: str) -> bool:
    """Leaves whose flax and torch names are their own: ``ProbsDiffusion``'s
    ``alpha``, the template's trainable anchors (``{conv}_anchor``),
    ``AnchorConv``'s ``anchor`` and the trainable ``pmiu`` of the GPN
    convs."""
    return name in ("alpha", "anchor", "pmiu") or name.endswith("_anchor")


def _flatten(tree: Mapping, prefix=()):
    for name, sub in tree.items():
        path = prefix + (str(name),)
        if isinstance(sub, Mapping):
            yield from _flatten(sub, path)
        else:
            yield path, sub


def _params_tree(params: Mapping) -> Mapping:
    return params["params"] if set(params) == {"params"} else params


def flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Nested mapping of numpy arrays (with or without the top-level
    ``params`` collection) -> {torch key: float32 tensor}.  Raises on a leaf
    that is not a Dense kernel or bias, a batch-norm scale, an
    ``edge_weights_trans``, a ``pw``, a ``pmiu``, an ``alpha``, an
    ``anchor`` or an ``*_anchor``."""
    out = {}
    for path, leaf in _flatten(_params_tree(params)):
        name = _LEAF.get(path[-1]) or (path[-1] if _kept(path[-1]) else None)
        if name is None:
            raise KeyError(f"unmapped flax leaf {'/'.join(path)}")
        arr = np.asarray(leaf, np.float32)
        if path[-1] == "kernel":
            if arr.ndim != 2:
                raise ValueError(f"{'/'.join(path)}: kernel of shape "
                                 f"{arr.shape} is not a Dense kernel")
            arr = arr.T
        key = ".".join(path[:-1] + (name,))
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def load_flax_params(model: nn.Module, params: Mapping) -> nn.Module:
    """Load a flax parameter tree into ``model``; raises on any key missing
    or left over on either side, or on a shape mismatch."""
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    return model


class Leaf(NamedTuple):
    """One parameter in the flat vector: its torch key, flax path and flax
    shape, and where it starts."""

    key: str
    path: Tuple[str, ...]
    shape: Tuple[int, ...]
    offset: int

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    def view(self, flat: torch.Tensor) -> torch.Tensor:
        """This leaf's slice of ``flat`` in the torch parameter's shape: a
        kernel's [in, out] block seen transposed as [out, in]."""
        v = flat[self.offset:self.offset + self.size].view(self.shape)
        return v.t() if self.path[-1] == "kernel" else v


def ravel_layout(model: nn.Module) -> List[Leaf]:
    """The ``ravel_pytree`` order of ``model``'s flax tree: leaves sorted by
    flax path (so ``feats10`` precedes ``feats2``)."""
    entries = []
    for key, p in model.named_parameters():
        *mods, name = key.split(".")
        flax_name = _FLAX_LEAF.get(name) or (name if _kept(name) else None)
        if flax_name is None or (name == "weight" and p.dim() != 2):
            raise KeyError(f"parameter {key} has no flax counterpart")
        shape = tuple(p.shape[::-1]) if name == "weight" else tuple(p.shape)
        entries.append((tuple(mods) + (flax_name,), key, shape))
    layout, offset = [], 0
    for path, key, shape in sorted(entries):
        leaf = Leaf(key, path, shape, offset)
        layout.append(leaf)
        offset += leaf.size
    return layout


def ravel_params(model: nn.Module, layout: List[Leaf]) -> torch.Tensor:
    """``model``'s parameters as one flat float32 vector in ``layout``."""
    sd = dict(model.named_parameters())
    parts = []
    for leaf in layout:
        p = sd[leaf.key].detach().float()
        parts.append((p.t() if leaf.path[-1] == "kernel" else p).reshape(-1))
    return torch.cat(parts)


def _field(obj, name):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def flax_train_state_to_torch(state, model: nn.Module, device="cpu"):
    """A JAX ``TrainState`` as numpy leaves (``step``, ``params``, and
    ``opt_state = (ScaleByAdamState(count, mu, nu),
    ScaleByScheduleState(count))`` of the flat optax Adam) -> the port's
    ``train.loop.TrainState`` for ``model``.  Raises on a leaf missing or
    left over, a shape or size mismatch, or counts that disagree."""
    from .train.loop import TrainState

    layout = ravel_layout(model)
    have = {path: np.asarray(leaf, np.float32)
            for path, leaf in _flatten(_params_tree(_field(state, "params")))}
    want = {leaf.path: leaf for leaf in layout}
    if set(have) != set(want):
        missing = sorted("/".join(p) for p in set(want) - set(have))
        extra = sorted("/".join(p) for p in set(have) - set(want))
        raise KeyError(f"flax leaves missing {missing}, unexpected {extra}")
    for path, arr in have.items():
        if arr.shape != want[path].shape:
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape}, the "
                             f"model wants {want[path].shape}")
    flat = np.concatenate([have[leaf.path].reshape(-1) for leaf in layout])
    adam, sched = _field(state, "opt_state")
    mu = np.asarray(_field(adam, "mu"), np.float32)
    nu = np.asarray(_field(adam, "nu"), np.float32)
    for name, arr in (("mu", mu), ("nu", nu)):
        if arr.shape != flat.shape:
            raise ValueError(f"Adam {name} has shape {arr.shape}, the flat "
                             f"parameters {flat.shape}")
    count = int(np.asarray(_field(adam, "count")))
    if int(np.asarray(_field(sched, "count"))) != count:
        raise ValueError("Adam and schedule counts differ")
    t = lambda a: torch.from_numpy(np.array(a)).to(device)  # noqa: E731
    return TrainState(step=int(np.asarray(_field(state, "step"))),
                      params=t(flat), mu=t(mu), nu=t(nu),
                      count=torch.tensor(count, dtype=torch.int32,
                                         device=device))
