"""Layer primitives (mirror of ``pointcloudsegmentation_tpu.models.layers``).

Submodule names follow the flax modules (``fc_{i}``, ``fc_out``,
``fc_embed``, ``mlp``, ``class_mlp{i}``) so that a flax parameter tree maps
onto a ``state_dict`` one to one (``convert.py``).  Weights are float32;
``dtype`` is the compute dtype (None = float32)."""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Linear):
    """``nn.Linear`` with Glorot-uniform weights and zero bias (the JAX
    package's ``Dense``).  With a compute ``dtype`` it casts input, weight
    and bias to it and returns that dtype, as flax ``Dense(dtype=...)``
    does; the bias is added after the product, as flax adds it."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: Optional[torch.dtype] = None):
        self.compute_dtype = dtype
        super().__init__(in_features, out_features, bias=bias)

    def reset_parameters(self) -> None:
        # real values come from init_glorot_ with an explicit generator
        nn.init.zeros_(self.weight)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    @torch.no_grad()
    def init_glorot_(self, generator: torch.Generator) -> None:
        limit = math.sqrt(6.0 / (self.in_features + self.out_features))
        self.weight.uniform_(-limit, limit, generator=generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        y = F.linear(x.to(dt), self.weight.to(dt))
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


def init_glorot_(module: nn.Module, generator: torch.Generator) -> None:
    """Initialize every Dense under ``module`` in ``named_modules`` order."""
    for _, m in module.named_modules():
        if isinstance(m, Dense):
            m.init_glorot_(generator)


class GrowthMLP(nn.Module):
    """Concat-growth MLP: each hidden layer's relu output is concatenated
    onto the running features (new first), then a linear projection."""

    def __init__(self, in_dim: int, dims: Sequence[int], out_dim: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_hidden = len(dims)
        w = in_dim
        for i, d in enumerate(dims):
            self.add_module(f"fc_{i}", Dense(w, d, dtype=dtype))
            w += d
        self.fc_out = Dense(w, out_dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_hidden):
            c = torch.relu(getattr(self, f"fc_{i}")(x))
            x = torch.cat([c, x], dim=-1)
        return self.fc_out(x)


class FCEmbed(nn.Module):
    """Leaky-ReLU (slope 0.01) Dense bottleneck before a conv."""

    def __init__(self, in_dim: int, dim: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.fc_embed = Dense(in_dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(self.fc_embed(x), 0.01)


class PointNetPoolMLP(nn.Module):
    """Per-point growth MLP on [dxyz ‖ feats] feeding a voxel max-pool."""

    def __init__(self, feat_dim: int, fc_dims: Sequence[int], out_dim: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.mlp = GrowthMLP(3 + feat_dim, fc_dims, out_dim, dtype=dtype)

    def forward(self, dxyz: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
        return self.mlp(torch.cat([dxyz, feats], dim=-1))


class SegClassifier(nn.Module):
    """Segmentation head (``classifier_v3``) on the encoder's factored head:
    the input already is the first Dense's pre-activation (head_dim wide),
    so relu -> concat(local) -> dropout -> Dense(256) -> relu -> concat ->
    dropout -> logits (the JAX ``SegClassifier(premixed=True)``).  Dropout
    (rate 0.3) runs only with ``train=True`` and draws from the given
    generator."""

    def __init__(self, num_classes: int, in_dim: int, pfeat_dim: int,
                 hidden: int = 256, dropout_rate: float = 0.3,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.class_mlp2 = Dense(in_dim + pfeat_dim, hidden, dtype=dtype)
        self.class_mlp3 = Dense(hidden + pfeat_dim, num_classes, dtype=dtype)

    def _dropout(self, x: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
        if generator is None:
            raise ValueError("train=True needs a generator for dropout")
        keep = 1.0 - self.dropout_rate
        u = torch.rand(x.shape, generator=generator, device=x.device)
        return torch.where(u < keep, x / keep, torch.zeros_like(x))

    def forward(self, feats: torch.Tensor, pfeats: torch.Tensor,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = torch.cat([torch.relu(feats), pfeats], dim=-1)
        if train:
            x = self._dropout(x, generator)
        x = torch.cat([torch.relu(self.class_mlp2(x)), pfeats], dim=-1)
        if train:
            x = self._dropout(x, generator)
        return self.class_mlp3(x)
