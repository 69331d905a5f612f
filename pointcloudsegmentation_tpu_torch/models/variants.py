"""The conv variants of the reference zoo (mirror of
``pointcloudsegmentation_tpu.models.variants``): the anchored ablation convs
``GPNConvV2``, ``compute_wlw``, ``DiffFeatsWLW`` and ``WLWConv``;
``ECDFeatsV4`` (pgnet_v7's conv), ``MaskedBatchNorm``, ``ECDXyzV2`` and
``ECDFeatsV2`` (pgnet_v6's), and ``DiffusionAnchorConv`` v1-v3 (v2 runs in
``template_diffusion_anchor``).

Submodule and parameter names are the flax ones, so ``convert.py`` maps
the trees one to one; the non-Dense leaves (``edge_weights_trans``, the
batch norm's ``scale``) keep their flax shapes.  Dtypes follow the
JAX layers: each Dense returns the compute dtype, and mixing it with a
float32 tensor or parameter promotes as jnp does.  Where a JAX layer
gathers one tensor twice (``neighbor_diff`` and ``gather_neighbors``), it
is gathered once here and the center subtracted."""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from ..ops import anchors as anchor_gen
from ..ops import neighbors as nb
from .layers import (Dense, add_growth, anchor_param, anchored_sum, glorot_,
                     growth, location_weights)


class GPNConvV2(nn.Module):
    """Weight-after-aggregate anchored conv (``graph_conv_{xyz,feats}_v2``;
    JAX ``models/variants.py:22-79``): per anchor the location-weighted
    mean of the slot features, ``Σ_k lw · sfeats / (Σ_k lw + 1e-6)`` with
    ``lw = exp((sxyz · scale_val) @ pmiu)`` over valid slots, flattened to
    [N, m·F], then ``@ pw`` [m·F, out] ``+ bias`` and ``activation``.
    ``mode="xyz"`` takes sxyz as the slot features, ``"feats"`` the
    gathered neighbor features.  ``pw`` and ``bias`` are the raw flax
    parameters; ``pmiu`` as ``GPNConv``'s (``pmiu_trainable``).  Given
    ``lw``/``lw_sum`` it uses them and creates no ``pmiu``, as the flax
    module does not (``shared_lw``).  Returns (out, lw, lw_sum)."""

    def __init__(self, in_dim: int, m: int, out_dim: int, mode: str = "xyz",
                 scale_val: float = 1.0,
                 activation: Optional[Callable] = torch.relu,
                 pmiu_trainable: bool = False, shared_lw: bool = False):
        super().__init__()
        if mode not in ("xyz", "feats"):
            raise ValueError(f"mode must be xyz or feats: {mode}")
        self.mode, self.m, self.out_dim = mode, m, out_dim
        self.scale_val, self.activation = scale_val, activation
        self.ifn = 3 if mode == "xyz" else in_dim
        self.pw = nn.Parameter(torch.zeros(m * self.ifn, out_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))
        self.shared_lw = shared_lw
        if not shared_lw:
            anchor_param(self, "pmiu", anchor_gen.cached_sphere_anchors(m),
                         pmiu_trainable)

    @torch.no_grad()
    def init_glorot_(self, generator: torch.Generator) -> None:
        glorot_(self.pw, self.m * self.ifn, self.out_dim, generator)
        self.bias.zero_()

    def forward(self, sxyz: torch.Tensor, feats: Optional[torch.Tensor],
                nbr, lw: Optional[torch.Tensor] = None,
                lw_sum: Optional[torch.Tensor] = None):
        """sxyz [N, K, 3] float32, feats [N, F] or None -> (out [N, out],
        lw [N, K, m], lw_sum [N, m])."""
        sfeats = sxyz if self.mode == "xyz" else \
            nb.gather_neighbors(feats, nbr)
        if lw is None:
            if self.shared_lw:
                raise ValueError("a shared_lw GPNConvV2 needs lw and lw_sum")
            lw, lw_sum = location_weights(sxyz, self.pmiu, nbr,
                                          self.scale_val)
        wfeats = anchored_sum(lw, sfeats) / (lw_sum[..., None] + 1e-6)
        wfeats = wfeats.reshape(wfeats.shape[0], -1)
        out = wfeats @ self.pw.to(wfeats.dtype) + self.bias
        if self.activation is not None:
            out = self.activation(out)
        return out, lw, lw_sum


def compute_wlw(sxyz: torch.Tensor, nbr, pmiu: torch.Tensor,
                scale_val: float = 1.0) -> torch.Tensor:
    """Pre-normalised Gaussian edge weights (``compute_wlw``; JAX
    ``models/variants.py:82-90``): the location weights over the valid
    slots divided by their sum over the slots + 1e-6, [N, K, m]."""
    lw, lw_sum = location_weights(sxyz, pmiu, nbr, scale_val)
    return lw / (lw_sum[:, None, :] + 1e-6)


def _normalise_slots(lw: torch.Tensor, nbr) -> torch.Tensor:
    lw = lw * nbr.mask[..., None].to(lw.dtype)
    return lw / (lw.sum(dim=1, keepdim=True) + 1e-6)


class DiffFeatsWLW(nn.Module):
    """MLP-predicted pre-normalised anchor weights from feature
    differences (``compute_diff_feats_wlw``; JAX ``models/variants.py:
    93-110``): a plain ReLU MLP (``fc_{i}``) on ``f_j - f_i``, m logits
    (``fc_weights``), clipped to ±10, exponentiated, normalised over the
    valid slots -> [N, K, m]."""

    def __init__(self, in_dim: int, m: int, fc_dims: Sequence[int],
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_fc = len(fc_dims)
        w = in_dim
        for i, d in enumerate(fc_dims):
            self.add_module(f"fc_{i}", Dense(w, d, dtype=dtype))
            w = d
        self.fc_weights = Dense(w, m, dtype=dtype)

    def forward(self, feats: torch.Tensor, nbr) -> torch.Tensor:
        x = nb.neighbor_diff(feats, nbr)
        for i in range(self.n_fc):
            x = torch.relu(getattr(self, f"fc_{i}")(x))
        lw = torch.exp(self.fc_weights(x).clamp(-10.0, 10.0))
        return _normalise_slots(lw, nbr)


class WLWConv(nn.Module):
    """Convs over pre-normalised edge weights ``wlw`` [N, K, m]
    (``graph_conv_{xyz,feats}_{sum,concat}``; JAX ``models/variants.py:
    113-144``).  ``sum``: each slot embedded to [m, out] (``embed``; on
    sxyz, or with ``use_xyz=False`` on the point features BEFORE the
    gather: the projection commutes with it), then ``Σ_m Σ_k wlw ·
    edge`` -> ``activation``.  ``concat``: per anchor ``Σ_k wlw`` times
    the raw slot features (sxyz, or the gathered features) -> [N, m·F] ->
    ``embed`` -> ``activation``."""

    def __init__(self, in_dim: int, m: int, out_dim: int, mode: str = "sum",
                 use_xyz: bool = True,
                 activation: Optional[Callable] = torch.relu,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if mode not in ("sum", "concat"):
            raise ValueError(f"mode must be sum or concat: {mode}")
        self.mode, self.use_xyz, self.m = mode, use_xyz, m
        self.out_dim, self.activation = out_dim, activation
        f = 3 if use_xyz else in_dim
        self.embed = Dense(f, m * out_dim, dtype=dtype) if mode == "sum" \
            else Dense(m * f, out_dim, dtype=dtype)

    def forward(self, sxyz: torch.Tensor, feats: Optional[torch.Tensor],
                nbr, wlw: torch.Tensor) -> torch.Tensor:
        """sxyz [N, K, 3], feats [N, F] or None, wlw [N, K, m] ->
        [N, out]."""
        if self.mode == "sum":
            edge = self.embed(sxyz) if self.use_xyz else \
                nb.gather_neighbors(self.embed(feats), nbr)
            edge = edge.reshape(edge.shape[:2] + (self.m, self.out_dim))
            dt = torch.promote_types(wlw.dtype, edge.dtype)
            out = torch.einsum("nkm,nkmo->no", wlw.to(dt), edge.to(dt))
        else:
            edge = sxyz if self.use_xyz else nb.gather_neighbors(feats, nbr)
            agg = anchored_sum(wlw, edge)
            out = self.embed(agg.reshape(agg.shape[0], -1))
        return self.activation(out) if self.activation is not None else out


def l2_normalise(ew: torch.Tensor) -> torch.Tensor:
    """``ew / (sqrt(sum(ew^2) + 1e-5) + 1e-5)`` over the last axis, in
    ew's dtype (JAX ``models/variants.py:167-168``, ``models/ecd.py:
    224-225``)."""
    norm = torch.sqrt((ew * ew).sum(dim=-1, keepdim=True) + 1e-5)
    return ew / (norm + 1e-5)


class ECDFeatsV4(nn.Module):
    """``ecd_feats_v4`` (JAX ``models/variants.py:147-175``): a growth MLP
    (``ifc_{i}``, new first) on ``[f_j - f_i ‖ sxyz]`` -> linear per-feature
    edge weights (``fc_ew``), l2-normalised and rescaled by the trainable
    ``edge_weights_trans`` [1, F] -> weighted neighbor features -> the
    eps-regularised mean -> linear ``fc_out``."""

    def __init__(self, in_dim: int, ifc_dims: Sequence[int], out_dim: int,
                 eps: float = 1e-3, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps = eps
        self.n_ifc = len(ifc_dims)
        w = add_growth(self, "ifc_", in_dim + 3, ifc_dims, dtype)
        self.fc_ew = Dense(w, in_dim, dtype=dtype)
        self.edge_weights_trans = nn.Parameter(torch.ones(1, in_dim))
        self.fc_out = Dense(in_dim, out_dim, dtype=dtype)

    def forward(self, sxyz: torch.Tensor, feats: torch.Tensor,
                nbr) -> torch.Tensor:
        edge = nb.gather_neighbors(feats, nbr)
        x = torch.cat([edge - feats[:, None, :], sxyz], dim=-1)
        x = growth(self, "ifc_", self.n_ifc, x, True)
        ew = l2_normalise(self.fc_ew(x)) * self.edge_weights_trans
        pooled = nb.masked_mean_eps(edge * ew, nbr, self.eps)
        return self.fc_out(pooled)


class MaskedBatchNorm(nn.Module):
    """Batch norm over the valid points of one block (JAX
    ``models/variants.py:177-198``): mean and variance of the current
    block's valid rows in both modes, in x's dtype, no running state;
    ``scale`` and ``bias`` are float32 [C]."""

    def __init__(self, dim: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        m = mask[:, None].to(x.dtype)
        cnt = m.sum().clamp(min=1.0)
        mean = (x * m).sum(dim=0, keepdim=True) / cnt
        var = (((x - mean) ** 2) * m).sum(dim=0, keepdim=True) / cnt
        return (x - mean) / torch.sqrt(var + self.eps) * self.scale \
            + self.bias


class ECDXyzV2(nn.Module):
    """``ecd_xyz_v2`` (JAX ``models/variants.py:200-233``): growth MLPs
    with the new columns last on sxyz give the edge features
    (``feats_fc_{i}``, ``final_feats_fc``) and tanh diffusion weights
    (``diffusion_fc_{i}``, ``final_diffusion_fc``); their product grows
    through ``embed_fc_{i}``, is eps-mean pooled, then ReLU
    ``out_embed_fc`` and ``out_bn``.  Gathers nothing."""

    def __init__(self, feats_dims: Sequence[int], final_feats_dim: int,
                 diffusion_dims: Sequence[int], trans_dims: Sequence[int],
                 out_dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n = (len(feats_dims), len(diffusion_dims), len(trans_dims))
        w = add_growth(self, "feats_fc_", 3, feats_dims, dtype)
        self.final_feats_fc = Dense(w, final_feats_dim, dtype=dtype)
        w = add_growth(self, "diffusion_fc_", 3, diffusion_dims, dtype)
        self.final_diffusion_fc = Dense(w, final_feats_dim, dtype=dtype)
        w = add_growth(self, "embed_fc_", final_feats_dim, trans_dims,
                       dtype)
        self.out_embed_fc = Dense(w, out_dim, dtype=dtype)
        self.out_bn = MaskedBatchNorm(out_dim)

    def forward(self, sxyz: torch.Tensor, nbr,
                mask: torch.Tensor) -> torch.Tensor:
        nf, nd, nt = self.n
        edge = self.final_feats_fc(growth(self, "feats_fc_", nf, sxyz,
                                           False))
        ew = torch.tanh(self.final_diffusion_fc(
            growth(self, "diffusion_fc_", nd, sxyz, False)))
        x = growth(self, "embed_fc_", nt, ew * edge, False)
        out = torch.relu(self.out_embed_fc(nb.masked_mean_eps(x, nbr)))
        return self.out_bn(out, mask)


class ECDFeatsV2(nn.Module):
    """``ecd_feats_v2`` (JAX ``models/variants.py:235-262``): a linear
    embed (``in_embed_fc``), tanh diffusion weights from a growth MLP with
    the new columns last on ``[e_j - e_i ‖ sxyz]``, the weighted gathered
    embeddings grown through ``embed_fc_{i}``, eps-mean pooled, then ReLU
    ``out_embed_fc`` and ``out_bn``."""

    def __init__(self, in_dim: int, embed_dim: int,
                 diffusion_dims: Sequence[int], trans_dims: Sequence[int],
                 out_dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n = (len(diffusion_dims), len(trans_dims))
        self.in_embed_fc = Dense(in_dim, embed_dim, dtype=dtype)
        w = add_growth(self, "diffusion_fc_", embed_dim + 3,
                       diffusion_dims, dtype)
        self.final_diffusion_fc = Dense(w, embed_dim, dtype=dtype)
        w = add_growth(self, "embed_fc_", embed_dim, trans_dims, dtype)
        self.out_embed_fc = Dense(w, out_dim, dtype=dtype)
        self.out_bn = MaskedBatchNorm(out_dim)

    def forward(self, sxyz: torch.Tensor, feats: torch.Tensor, nbr,
                mask: torch.Tensor) -> torch.Tensor:
        nd, nt = self.n
        emb = self.in_embed_fc(feats)
        edge = nb.gather_neighbors(emb, nbr)
        w = torch.cat([edge - emb[:, None, :], sxyz], dim=-1)
        ew = torch.tanh(self.final_diffusion_fc(
            growth(self, "diffusion_fc_", nd, w, False)))
        x = growth(self, "embed_fc_", nt, ew * edge, False)
        out = torch.relu(self.out_embed_fc(nb.masked_mean_eps(x, nbr)))
        return self.out_bn(out, mask)


class DiffusionAnchorConv(nn.Module):
    """The edge-condition diffusion-anchor convs v1-v3
    (``edge_condition_diffusion_anchor``; JAX ``models/variants.py:
    264-329``): a growth MLP (``fc_weights_{i}``, new first,
    ``fc_weights_final``) on sxyz predicts per-slot anchor weights, which
    weigh the gathered neighbor features, summed per anchor and projected
    by ``fc_out``.  v1: ``exp(clip(w, ±10)) + 1e-5`` normalised by the
    per-anchor weight sum, raw features, ReLU out; v2: sigmoid weights on
    features embedded to [an·ed] (``fc_embed``), divided by the valid
    count, ReLU out; v3: l2-normalised weights as v2, linear out.  (v4 is
    ``ecd.MLPAnchorConv``.)"""

    def __init__(self, in_dim: int, version: int, anchor_num: int,
                 out_dim: int, weights_dims: Sequence[int],
                 embed_dim: int = 0, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if version not in (1, 2, 3):
            raise ValueError(f"version must be 1, 2 or 3: {version}")
        self.version, self.an, self.ed = version, anchor_num, embed_dim
        self.n_w = len(weights_dims)
        if version == 1:
            width = in_dim
        else:
            self.fc_embed = Dense(in_dim, anchor_num * embed_dim, dtype=dtype)
            width = embed_dim
        w = add_growth(self, "fc_weights_", 3, weights_dims, dtype)
        self.fc_weights_final = Dense(w, anchor_num, dtype=dtype)
        self.fc_out = Dense(anchor_num * width, out_dim, dtype=dtype)

    def forward(self, sxyz: torch.Tensor, feats: torch.Tensor,
                nbr) -> torch.Tensor:
        n, k = sxyz.shape[:2]
        pfeats = feats if self.version == 1 else self.fc_embed(feats)
        ew = self.fc_weights_final(growth(self, "fc_weights_", self.n_w,
                                          sxyz, True))
        if self.version == 1:
            ew = torch.exp(ew.clamp(-10.0, 10.0)) + 1e-5
        elif self.version == 2:
            ew = torch.sigmoid(ew)
        else:
            ew = l2_normalise(ew)
        ew = ew * nbr.mask[..., None].to(ew.dtype)
        edge = nb.gather_neighbors(pfeats, nbr)
        if self.version == 1:
            wf = anchored_sum(ew, edge)
            wf = wf / ew.sum(dim=1)[..., None].clamp(min=1e-12)
            return torch.relu(self.fc_out(wf.reshape(n, -1)))
        edge = edge.reshape(n, k, self.an, self.ed)
        dt = torch.promote_types(ew.dtype, edge.dtype)
        wf = torch.einsum("nka,nkae->nae", ew.to(dt), edge.to(dt))
        wf = wf.reshape(n, -1) / nbr.counts()[:, None].clamp(min=1.0)
        out = self.fc_out(wf)
        return torch.relu(out) if self.version == 2 else out
