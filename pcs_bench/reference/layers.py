"""Layer primitives: a frozen copy of the port's ``models/layers.py`` (the
layers the PointNet and ECD encoders and the segmentation head use).
Weights are float32; ``dtype`` is the compute dtype (None = float32).
``Dense.fp8`` makes a layer round both matmul operands to float8 e4m3 with
a per-tensor scale (the benchmark's lower-precision control)."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from . import neighbors as nb


# the largest finite float8 e4m3 value
_E4M3_MAX = 448.0


def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale (its largest
    magnitude maps to 448), returned in ``x``'s dtype; the gradient passes
    straight through."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = amax / _E4M3_MAX
    q = (x.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q.to(x.dtype) - x).detach()


class Dense(nn.Linear):
    """``nn.Linear`` with zero-initialised parameters (the benchmark loads
    every weight).  With a compute ``dtype`` it casts input, weight and bias
    to it and returns that dtype; the bias is added after the product.
    With ``fp8`` set, both matmul operands are first rounded to float8 e4m3
    (``fake_fp8``)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: Optional[torch.dtype] = None):
        self.compute_dtype = dtype
        self.fp8 = False
        super().__init__(in_features, out_features, bias=bias)

    def reset_parameters(self) -> None:
        nn.init.zeros_(self.weight)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        x, w = x.to(dt), self.weight.to(dt)
        if self.fp8:
            x, w = fake_fp8(x), fake_fp8(w)
        y = F.linear(x, w)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


def add_growth(module: nn.Module, prefix: str, in_dim: int,
               dims: Sequence[int], dtype: Optional[torch.dtype]) -> int:
    """Register the Dense layers ``{prefix}{i}`` of a concat-growth stack on
    ``in_dim`` columns; returns the grown width."""
    w = in_dim
    for i, d in enumerate(dims):
        module.add_module(f"{prefix}{i}", Dense(w, d, dtype=dtype))
        w += d
    return w


def growth(module: nn.Module, prefix: str, n: int, x: torch.Tensor,
           new_first: bool) -> torch.Tensor:
    """Run a stack registered by ``add_growth``: each of its n layers'
    relu output joins x before it (``new_first``) or after it."""
    for i in range(n):
        c = torch.relu(getattr(module, f"{prefix}{i}")(x))
        x = torch.cat([c, x] if new_first else [x, c], dim=-1)
    return x


class GrowthMLP(nn.Module):
    """Concat-growth MLP: each hidden layer's relu output is concatenated
    onto the running features, then a linear projection.  The new columns
    go first (pointnet_conv/mlp) or, with ``new_first=False``, last
    (pointnet_deconv, model_pointnet.py:91-94)."""

    def __init__(self, in_dim: int, dims: Sequence[int], out_dim: int,
                 new_first: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_hidden = len(dims)
        self.new_first = new_first
        w = in_dim
        for i, d in enumerate(dims):
            self.add_module(f"fc_{i}", Dense(w, d, dtype=dtype))
            w += d
        self.fc_out = Dense(w, out_dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_hidden):
            c = torch.relu(getattr(self, f"fc_{i}")(x))
            x = torch.cat([c, x] if self.new_first else [x, c], dim=-1)
        return self.fc_out(x)


class PointNetConv(nn.Module):
    """PointNet conv + masked max (``pointnet_conv``, model_pointnet.py:
    10-24): each slot's edge input ``[center ‖ neighbor ‖ sxyz]`` -> MLP
    (``fc_{i}``, ``fc_out``) -> max over the neighborhood's valid slots,
    windowed and overflow, 0 where no slot is valid.

    ``concat_growth=False`` gives the plain MLP (``pointnet_conv_noconcat``,
    :41-54); ``use_feats=False`` the xyz-only conv, whose edge input is
    sxyz alone (``pointnet_conv_nofeats``, :26-39) and which gathers
    nothing.  The rows are gathered in the compute dtype (the cast commutes
    with the gather, and each Dense casts to it anyway), the windowed slots
    of a WindowedNeighborhood through the window-gather kernel."""

    def __init__(self, in_dim: int, fc_dims: Sequence[int], out_dim: int,
                 concat_growth: bool = True, use_feats: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.concat_growth = concat_growth
        self.use_feats = use_feats
        self.dtype = dtype
        self.n_hidden = len(fc_dims)
        w = 2 * in_dim + 3 if use_feats else 3
        for i, d in enumerate(fc_dims):
            self.add_module(f"fc_{i}", Dense(w, d, dtype=dtype))
            w = w + d if concat_growth else d
        self.fc_out = Dense(w, out_dim, dtype=dtype)

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_hidden):
            c = torch.relu(getattr(self, f"fc_{i}")(x))
            x = torch.cat([c, x], dim=-1) if self.concat_growth else c
        return self.fc_out(x)

    def forward(self, sxyz: torch.Tensor, feats: Optional[torch.Tensor],
                nbr, edges=None, edge_band=None,
                edge_rescale: float = 1.0) -> torch.Tensor:
        """sxyz [N, K, 3] (already rescaled), feats [N, F] (None for the
        xyz-only conv), nbr a Neighborhood or WindowedNeighborhood ->
        [N, out].  With an ``EdgeOverflow`` (``edges``), its rows within
        ``edge_band`` = (min_radius, max_radius) run the same MLP on
        ``[feats[center] ‖ feats[nbr] ‖ edges.sxyz / edge_rescale]`` (the
        sxyz alone for the xyz-only conv) and join the max (JAX
        ``models/layers.py:140-160``)."""
        x = sxyz
        if self.use_feats:
            feats = feats.to(self.dtype or feats.dtype)
            x = torch.cat([nb.neighbor_concat(feats, nbr),
                           sxyz.to(feats.dtype)], dim=-1)
        e_out = None
        if edges is not None:
            xe = (edges.sxyz / edge_rescale).to(sxyz.dtype)
            if self.use_feats:
                xe = torch.cat([feats[edges.center.long()],
                                feats[edges.nbr.long()],
                                xe.to(feats.dtype)], dim=-1)
            e_out = self._mlp(xe)
        return nb.masked_max(self._mlp(x), nbr, edges, edge_band, e_out)


class ECDConv(nn.Module):
    """Edge-conditioned diffusion conv (``diff_feats_ecd``/``ecd_feats``;
    JAX ``models/layers.py:179-222``): a growth MLP (``ifc_{i}``, new
    columns first) on ``[f_j - f_i ‖ sxyz]`` -> tanh edge weights of the
    features' width (``fc_ew``) -> weighted neighbor features -> a growth
    MLP (``ofc_{i}``) -> the eps-regularised mean over valid slots -> ReLU
    ``fc_out``.

    ``use_xyz_only=True`` is ``ecd_xyz``: the edge feature is the grown
    sxyz itself, the weights take its width, and nothing is gathered.  The
    JAX layer gathers the features twice (``neighbor_diff`` and
    ``gather_neighbors``); here they are gathered once and the center
    subtracted, the same function with one window gather (and one
    slab-gradient backward) per conv.  Dtypes follow the JAX layer: each
    Dense returns the compute dtype, and mixing it with float32 sxyz
    promotes as jnp does."""

    def __init__(self, in_dim: int, phi_dims: Sequence[int],
                 g_dims: Sequence[int], out_dim: int,
                 use_xyz_only: bool = False, eps: float = 1e-3,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.use_xyz_only = use_xyz_only
        self.eps = eps
        self.n_phi, self.n_g = len(phi_dims), len(g_dims)
        w = add_growth(self, "ifc_", 3 if use_xyz_only else in_dim + 3,
                       phi_dims, dtype)
        ifn = w if use_xyz_only else in_dim
        self.fc_ew = Dense(w, ifn, dtype=dtype)
        w = add_growth(self, "ofc_", ifn, g_dims, dtype)
        self.fc_out = Dense(w, out_dim, dtype=dtype)

    def forward(self, sxyz: torch.Tensor, feats: Optional[torch.Tensor],
                nbr) -> torch.Tensor:
        """sxyz [N, K, 3], feats [N, F] (None for ``use_xyz_only``) ->
        [N, out]."""
        if self.use_xyz_only:
            phi = sxyz
        else:
            edge = nb.gather_neighbors(feats, nbr)
            phi = torch.cat([edge - feats[:, None, :], sxyz], dim=-1)
        phi = growth(self, "ifc_", self.n_phi, phi, True)
        if self.use_xyz_only:
            edge = phi
        x = growth(self, "ofc_", self.n_g, torch.tanh(self.fc_ew(phi)) * edge,
                   True)
        pooled = nb.masked_mean_eps(x, nbr, self.eps)
        return torch.relu(self.fc_out(pooled))


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
    """The reference's segmentation-head family (JAX
    ``models/layers.py:335-397``); by default ``classifier_v3``:
    Dense(512) -> relu -> concat(local) -> dropout -> Dense(256) -> relu
    -> concat -> dropout -> logits (``class_mlp1..3``).  ``dims`` sets the
    hidden widths and ``use_pfeats=False`` drops the local-feature concats
    (``pfeat_dim`` is then unused).
    With ``premixed`` (the JAX ``SegClassifier(premixed=True)``) the input
    already is the first Dense's pre-activation (the encoder's factored
    head, ``dims[0]`` wide), so there is no ``class_mlp1``; without it
    ``class_mlp1`` maps ``in_dim`` columns to ``dims[0]``.  Dropout (rate
    0.3) runs only with ``train=True`` and draws from the given
    generator."""

    def __init__(self, num_classes: int, in_dim: int, pfeat_dim: int,
                 premixed: bool = False, dropout_rate: float = 0.3,
                 dtype: Optional[torch.dtype] = None,
                 dims: Tuple[int, ...] = (512, 256), use_pfeats: bool = True):
        super().__init__()
        if premixed and in_dim != dims[0]:
            raise ValueError(f"a premixed head takes {dims[0]} columns, got "
                             f"{in_dim}")
        self.premixed = premixed
        self.dropout_rate = dropout_rate
        self.dims = tuple(dims)
        self.use_pfeats = use_pfeats
        extra = pfeat_dim if use_pfeats else 0
        w = in_dim
        for i, d in enumerate(self.dims):
            if i or not premixed:
                self.add_module(f"class_mlp{i + 1}", Dense(w, d, dtype=dtype))
            w = d + extra
        self.add_module(f"class_mlp{len(self.dims) + 1}",
                        Dense(w, num_classes, dtype=dtype))

    def _dropout(self, x: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
        if generator is None:
            raise ValueError("train=True needs a generator for dropout")
        keep = 1.0 - self.dropout_rate
        u = torch.rand(x.shape, generator=generator, device=x.device)
        return torch.where(u < keep, x / keep, torch.zeros_like(x))

    def forward(self, feats: torch.Tensor,
                pfeats: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = feats
        for i in range(len(self.dims)):
            if i or not self.premixed:
                x = getattr(self, f"class_mlp{i + 1}")(x)
            x = torch.relu(x)
            if self.use_pfeats:
                x = torch.cat([x, pfeats], dim=-1)
            if train:
                x = self._dropout(x, generator)
        return getattr(self, f"class_mlp{len(self.dims) + 1}")(x)


