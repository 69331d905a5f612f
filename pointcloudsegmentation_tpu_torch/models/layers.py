"""Layer primitives (mirror of ``pointcloudsegmentation_tpu.models.layers``).

Submodule names follow the flax modules (``fc_{i}``, ``fc_out``,
``fc_embed``, ``mlp``, ``class_mlp{i}``) so that a flax parameter tree maps
onto a ``state_dict`` one to one (``convert.py``); ``GPNConv``'s raw
parameters (``pw``, ``bias``) keep their flax names and shapes.  Weights
are float32; ``dtype`` is the compute dtype (None = float32)."""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import anchors as anchor_gen
from ..ops import neighbors as nb


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
        glorot_(self.weight, self.in_features, self.out_features, generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        y = F.linear(x.to(dt), self.weight.to(dt))
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


def glorot_(w: torch.Tensor, fan_in: int, fan_out: int,
            generator: torch.Generator) -> None:
    """Glorot-uniform draw in place: U(-l, l), l = sqrt(6 / (in + out))."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    w.uniform_(-limit, limit, generator=generator)


def init_glorot_(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every Glorot-initialised weight under ``module`` in
    ``named_modules`` order: each Dense's, and the ``pw`` of each
    ``GPNConv`` (the modules with their own ``init_glorot_``); biases go
    to zero."""
    for _, m in module.named_modules():
        if callable(getattr(m, "init_glorot_", None)):
            m.init_glorot_(generator)


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


def anchor_param(module: nn.Module, name: str, init: np.ndarray,
                 trainable: bool) -> None:
    """Register anchor directions ``init`` under ``name``: a Parameter
    (a flax leaf of that name, mapped by ``convert.py``; no Glorot draw
    touches it) when ``trainable``, else a buffer left out of the
    ``state_dict`` (a constant the flax tree has no leaf for)."""
    t = torch.from_numpy(np.array(init, np.float32))
    if trainable:
        module.register_parameter(name, nn.Parameter(t))
    else:
        module.register_buffer(name, t, persistent=False)


class AnchorConv(nn.Module):
    """Explicit-anchor Gaussian conv (``anchor_conv_v2``; JAX
    ``models/layers.py:225-260``): the features embedded to [an·ed]
    (``fc_embed``) and gathered per slot, weighted per anchor by
    ``exp(-rescale_ratio · |sxyz - anchor|²)`` over the valid slots,
    summed over the slots, then ReLU ``fc_out``.  ``anchor`` [an, 3]
    starts at ``sphere_kmeans_anchors(an).T`` (rows, unlike ``pmiu``'s
    columns), trainable unless ``trainable_anchor=False``."""

    def __init__(self, in_dim: int, out_dim: int, anchor_num: int,
                 embed_dim: int, rescale_ratio: float = 4.0,
                 trainable_anchor: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.an, self.ed = anchor_num, embed_dim
        self.rescale_ratio = rescale_ratio
        self.fc_embed = Dense(in_dim, anchor_num * embed_dim, dtype=dtype)
        anchor_param(self, "anchor",
                     anchor_gen.cached_sphere_anchors(anchor_num).T,
                     trainable_anchor)
        self.fc_out = Dense(anchor_num * embed_dim, out_dim, dtype=dtype)

    def forward(self, sxyz: torch.Tensor, feats: torch.Tensor,
                nbr) -> torch.Tensor:
        """sxyz [N, K, 3], feats [N, F] -> [N, out]."""
        n, k = sxyz.shape[:2]
        edge = nb.gather_neighbors(self.fc_embed(feats), nbr)
        edge = edge.reshape(n, k, self.an, self.ed)
        d2 = ((sxyz[:, :, None, :] - self.anchor) ** 2).sum(dim=-1)
        w = torch.exp(-d2 * self.rescale_ratio)                 # [N, K, an]
        w = w * nbr.mask[..., None].to(w.dtype)
        dt = torch.promote_types(w.dtype, edge.dtype)
        agg = torch.einsum("nka,nkae->nae", w.to(dt), edge.to(dt))
        return torch.relu(self.fc_out(agg.reshape(n, -1)))


def anchored_sum(lw: torch.Tensor, edge: torch.Tensor) -> torch.Tensor:
    """``einsum("nkm,nkf->nmf")`` in the dtype jnp promotes the two to
    (float32 for float32 weights), as the JAX layers compute it."""
    dt = torch.promote_types(lw.dtype, edge.dtype)
    return torch.einsum("nkm,nkf->nmf", lw.to(dt), edge.to(dt))


def location_weights(sxyz: torch.Tensor, pmiu: torch.Tensor, nbr,
                     scale_val: float = 1.0):
    """The GPN convs' location weights: ``lw = exp((sxyz·scale) @ pmiu)``
    [N, K, m] over the valid slots and their sum over the slots [N, m]
    (JAX ``models/layers.py:310-318``, ``models/variants.py:60-68``)."""
    if scale_val != 1.0:
        sxyz = sxyz * scale_val
    lw = torch.exp(sxyz @ pmiu)
    lw = lw * nbr.mask[..., None].to(lw.dtype)
    return lw, lw.sum(dim=1)


class GPNConv(nn.Module):
    """Gaussian-anchored location-weighted conv (the "GPN" conv; JAX
    ``models/layers.py:263-332``): location weights ``lw = exp(sxyz ·
    pmiu)`` [N, K, m] over valid slots, and per anchor ``Σ_k lw ·
    (cfeats @ pw) / (Σ_k lw + 1e-6)``, factored as ``agg =
    einsum("nkm,nkf->nmf", lw, cfeats)`` then ``einsum("nmf,fmo->nmo",
    agg, pw)``, so no [N, K, m, out] tensor exists; summed over the
    anchors to [N, out], or with ``no_sum`` (as ``GPNStage`` builds it)
    flattened to [N, m·out]; plus ``bias`` of that width
    (``use_bias``), then ``activation`` (ReLU; None for none).

    ``mode`` picks cfeats: ``xyz`` the slot offsets sxyz [N, K, 3],
    ``feats`` the gathered neighbor features, ``xyz_feats`` both, sxyz
    first.  The weights, the aggregation and the output are float32
    whatever the gathered features' dtype (a float32 ``pw`` promotes
    them, as in JAX).  ``pw`` [ifn, m·out] is the raw flax parameter.
    ``pmiu`` [3, m], the anchor directions, starts at the sphere k-means:
    a constant (``anchor_param``) or, with ``pmiu_trainable``, the flax
    ``pmiu`` leaf.  A conv built with ``shared_lw`` has none and takes the
    ``lw``/``lw_sum`` another conv of its stage returned (the flax module
    creates no ``pmiu`` when it is given them).  Returns (out, lw,
    lw_sum)."""

    MODES = ("xyz", "feats", "xyz_feats")

    def __init__(self, in_dim: int, m: int, out_dim: int,
                 mode: str = "xyz_feats", use_bias: bool = True,
                 activation: Optional[Callable] = torch.relu,
                 pmiu_trainable: bool = False, no_sum: bool = False,
                 shared_lw: bool = False):
        super().__init__()
        if mode not in self.MODES:
            raise ValueError(f"mode must be one of {self.MODES}: {mode}")
        self.mode, self.m, self.out_dim = mode, m, out_dim
        self.no_sum, self.activation = no_sum, activation
        self.ifn = {"xyz": 3, "feats": in_dim, "xyz_feats": 3 + in_dim}[mode]
        self.pw = nn.Parameter(torch.zeros(self.ifn, m * out_dim))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(m * out_dim if no_sum
                                                 else out_dim))
        else:
            self.bias = None
        self.shared_lw = shared_lw
        if not shared_lw:
            anchor_param(self, "pmiu", anchor_gen.cached_sphere_anchors(m),
                         pmiu_trainable)

    @torch.no_grad()
    def init_glorot_(self, generator: torch.Generator) -> None:
        glorot_(self.pw, self.ifn, self.m * self.out_dim, generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, sxyz: torch.Tensor, feats: Optional[torch.Tensor],
                nbr, lw: Optional[torch.Tensor] = None,
                lw_sum: Optional[torch.Tensor] = None):
        """sxyz [N, K, 3] float32 (raw offsets), feats [N, F] or None ->
        (out [N, out] or [N, m·out], lw [N, K, m], lw_sum [N, m])."""
        if self.mode == "xyz":
            cfeats = sxyz
        else:
            cfeats = nb.gather_neighbors(feats, nbr)
            if self.mode == "xyz_feats":
                dt = torch.promote_types(sxyz.dtype, cfeats.dtype)
                cfeats = torch.cat([sxyz.to(dt), cfeats.to(dt)], dim=-1)
        if lw is None:
            if self.shared_lw:
                raise ValueError("a shared_lw GPNConv needs lw and lw_sum")
            lw, lw_sum = location_weights(sxyz, self.pmiu, nbr)
        agg = anchored_sum(lw, cfeats)
        pw3 = self.pw.view(self.ifn, self.m, self.out_dim)
        num = torch.einsum("nmf,fmo->nmo", agg, pw3.to(agg.dtype))
        out = num / (lw_sum[..., None] + 1e-6)
        out = out.reshape(out.shape[0], -1) if self.no_sum else out.sum(1)
        if self.bias is not None:
            out = out + self.bias
        if self.activation is not None:
            out = self.activation(out)
        return out, lw, lw_sum


class ProbsDiffusion(nn.Module):
    """Iterative label smoothing (``graph_probs_diffusion``; JAX
    ``models/layers.py:400-414``): ``steps`` times, each point's
    probabilities mix with the mean over its valid neighbors with weight
    ``sigmoid(alpha)``.  ``alpha`` [1] starts at 0 (a weight of 0.5) and no
    Glorot draw touches it."""

    def __init__(self, steps: int = 3):
        super().__init__()
        self.steps = steps
        self.alpha = nn.Parameter(torch.zeros(1))

    def forward(self, probs: torch.Tensor, nbr) -> torch.Tensor:
        """probs [N, C] float32, nbr a Neighborhood -> [N, C]."""
        alpha = torch.sigmoid(self.alpha)
        for _ in range(self.steps):
            neigh = nb.masked_mean(nb.gather_neighbors(probs, nbr), nbr)
            probs = (1.0 - alpha) * probs + alpha * neigh
        return probs


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


def classifier_v2(num_classes: int, in_dim: int, **kw) -> SegClassifier:
    """``classifier_v2`` (JAX ``models/layers.py:382-385``): 256/128, no
    local-feature concat, so no ``pfeat_dim``.  Unfactored (``class_mlp1``
    on ``in_dim`` columns) unless ``premixed=True`` is passed."""
    return SegClassifier(num_classes, in_dim, 0, dims=(256, 128),
                         use_pfeats=False, **kw)


def classifier_v4(num_classes: int, in_dim: int, pfeat_dim: int,
                  **kw) -> SegClassifier:
    """``classifier_v4`` (JAX ``:388-390``): 256/128 with the local-feature
    concats; unfactored unless ``premixed=True``."""
    return SegClassifier(num_classes, in_dim, pfeat_dim, dims=(256, 128),
                         **kw)


def classifier_v5(num_classes: int, in_dim: int, pfeat_dim: int,
                  **kw) -> SegClassifier:
    """``classifier_v5`` (JAX ``:393-397``): the same structure as v3, the
    named constructor of the refine cascade's heads; unfactored unless
    ``premixed=True``."""
    return SegClassifier(num_classes, in_dim, pfeat_dim, **kw)
