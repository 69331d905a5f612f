"""The plain reference of a segmentation cell: the model, its flat
parameter layout, the loss, Adam and the dropout streams, in plain PyTorch.

It imports nothing of the program.  Its layers are frozen copies of the
port's (``pointnet.py``, ``ecd.py``, ``layers.py``, ...) with every kernel
replaced by plain indexing, so a later change to the program cannot move
it.  It runs in float32 as the reference, or as the lower-precision
control: bfloat16 activations with every matmul's operands rounded to
float8 e4m3 (``build(..., "fp8")``).  TF32 stays off while it runs
(``no_tf32``)."""
from __future__ import annotations

import contextlib
import importlib
import math
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from . import hierarchy as hier, morton
from .layers import Dense, SegClassifier

# optax.adam defaults
B1, B2, EPS = 0.9, 0.999, 1e-8


class SegmentationModel(nn.Module):
    """Morton sort -> voxel pyramid -> encoder -> head -> per-point logits
    in the caller's point order."""

    def __init__(self, encoder: nn.Module, cfg: Dict,
                 dtype: Optional[torch.dtype]):
        super().__init__()
        self.encoder = encoder
        self.head = SegClassifier(cfg["num_classes"], encoder.out_width,
                                  encoder.stage0_width,
                                  premixed=encoder.head_dim is not None,
                                  dtype=dtype)
        self.voxel_sizes = tuple(cfg["voxel_sizes"])
        self.caps = tuple(cfg["caps"])
        self.block_size = cfg["block_size"]

    def pyramid(self, xyz, mask, feats):
        """(the Morton order, the pyramid, the sorted features)."""
        cell = self.voxel_sizes[0] / 4.0
        xyz, mask, order, feats = morton.sort_block(
            xyz, mask, cell, self.block_size, feats)
        pyr = hier.build_pyramid(xyz, mask, self.voxel_sizes, self.caps,
                                 self.block_size, morton_sorted=True)
        return order, pyr, feats

    def forward(self, xyz, feats, mask, train: bool = False,
                generator: Optional[torch.Generator] = None):
        order, pyr, feats = self.pyramid(xyz, mask, feats)
        gf, lf = self.encoder(pyr, feats)
        logits = self.head(gf, lf, train, generator)
        return logits[morton.inverse_permutation(order)]


# compute precisions: (activation dtype, float8 matmul operands)
COMPUTE = {"float32": (None, False), "bfloat16": (torch.bfloat16, False),
           "fp8": (torch.bfloat16, True)}


def build(cfg: Dict, device, compute: str = "float32") -> SegmentationModel:
    """The model of configuration ``cfg`` (a configuration file's object)
    with zero parameters, computing in float32 (the reference), bfloat16,
    or bfloat16 with float8 matmul operands (the control, ``"fp8"``).  The
    encoder comes from ``build_encoder`` of the module ``cfg["encoder"]``
    names."""
    dtype, fp8 = COMPUTE[compute]
    # the file's ``encoder`` names a module of this package that builds it
    encoder = importlib.import_module(f".{cfg['encoder']}", __package__
                                      ).build_encoder(cfg, dtype)
    model = SegmentationModel(encoder, cfg, dtype)
    for m in model.modules():
        if isinstance(m, Dense):
            m.fp8 = fp8
    return model.to(device)


# the leaf kinds of the port's encoders, by the parameter's own name: its
# name in the flat layout's sorted paths and how it starts, ``GLOROT`` (a
# uniform draw within the Glorot limit of its two stored dims) or that
# constant.  Only ``weight``, a Dense weight, is stored [in, out] as a
# ``kernel``; a GPN conv's ``pw`` [ifn, m * out] is stored as it is.
GLOROT = "glorot"
LEAF_KINDS = {"weight": ("kernel", GLOROT), "bias": ("bias", 0.0),
              "pw": ("pw", GLOROT),
              "edge_weights_trans": ("edge_weights_trans", 1.0),
              "scale": ("scale", 1.0)}


class Leaf(NamedTuple):
    """One parameter in the flat vector: its name, its stored shape (a Dense
    weight as [in, out]), where it starts, and how it starts: drawn within
    its Glorot ``limit``, or (``limit`` 0) the constant ``const``."""
    key: str
    shape: Tuple[int, ...]
    offset: int
    limit: float
    const: float = 0.0

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def kernel(self) -> bool:
        """A Dense weight, stored [in, out] and seen transposed."""
        return self.key.rsplit(".", 1)[-1] == "weight"

    def view(self, flat: torch.Tensor) -> torch.Tensor:
        v = flat[self.offset:self.offset + self.size].view(self.shape)
        return v.t() if self.kernel else v


def layout(model: nn.Module) -> List[Leaf]:
    """The flat order of the parameters: sorted by their path with a Dense
    weight named ``kernel`` and stored [in, out], as
    ``jax.flatten_util.ravel_pytree`` lays out a flax tree.  A parameter of
    a kind not in ``LEAF_KINDS`` (a trainable anchor, ``alpha``, a
    trainable ``pmiu``), or a ``weight`` that is not 2-D, raises."""
    entries = []
    for key, p in model.named_parameters():
        *mods, name = key.split(".")
        if name not in LEAF_KINDS or (name == "weight" and p.dim() != 2):
            raise KeyError(f"parameter {key} is of no leaf kind the "
                           f"benchmark lays out: {', '.join(LEAF_KINDS)} "
                           f"(a weight 2-D)")
        path_name, start = LEAF_KINDS[name]
        shape = tuple(p.shape[::-1]) if name == "weight" else tuple(p.shape)
        if start == GLOROT:
            limit, const = math.sqrt(6.0 / (shape[0] + shape[1])), 0.0
        else:
            limit, const = 0.0, start
        entries.append((tuple(mods) + (path_name,), key, shape, limit, const))
    out, offset = [], 0
    for _, key, shape, limit, const in sorted(entries):
        out.append(Leaf(key, shape, offset, limit, const))
        offset += out[-1].size
    return out


def load_flat(model: nn.Module, leaves: List[Leaf],
              flat: torch.Tensor) -> None:
    """Copy the flat float32 vector into the model's parameters."""
    params = dict(model.named_parameters())
    with torch.no_grad():
        for leaf in leaves:
            params[leaf.key].copy_(leaf.view(flat))


def flat_grad(model: nn.Module, leaves: List[Leaf]) -> torch.Tensor:
    params = dict(model.named_parameters())
    parts = []
    for leaf in leaves:
        g = params[leaf.key].grad
        g = torch.zeros_like(params[leaf.key]) if g is None else g
        parts.append((g.t() if leaf.kernel else g).reshape(-1))
    return torch.cat(parts).float()


def loss_terms(logits: torch.Tensor, labels: torch.Tensor,
               mask: torch.Tensor, class_weights: torch.Tensor):
    """Class-weighted cross entropy over the valid points, unnormalised:
    (sum of w * ce, sum of w), in float32."""
    logits = logits.float()
    c = logits.shape[-1]
    valid = mask & (labels >= 0) & (labels < c)
    labels = labels.clamp(0, c - 1).long()
    ce = -torch.log_softmax(logits, dim=-1).gather(-1, labels[:, None])[:, 0]
    w = class_weights[labels] * valid.float()
    return (w * ce).sum(), w.sum()


def dropout_generator(seed: int, step: int, block: int,
                      device) -> torch.Generator:
    """The dropout stream of block ``block`` of step ``step`` of a run whose
    training seed is ``seed``."""
    s = np.random.SeedSequence([seed, step, block]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device).manual_seed(int(s) & 0x7FFFFFFFFFFFFFFF)


def adam(params, mu, nu, count: int, grads, lr: float):
    """One optax ``adam`` step on flat float32 vectors; returns (params, mu,
    nu)."""
    mu = (1 - B1) * grads + B1 * mu
    nu = (1 - B2) * grads * grads + B2 * nu
    c = count + 1
    mu_hat = mu / (1 - B1 ** c)
    nu_hat = nu / (1 - B2 ** c)
    return params - lr * (mu_hat / (torch.sqrt(nu_hat) + EPS)), mu, nu


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    """float32 matmuls in float32, not TF32, for the duration."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
