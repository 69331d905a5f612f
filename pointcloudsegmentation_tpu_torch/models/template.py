"""The pluggable-stage template harness and the refine cascade's second
network (mirror of ``pointcloudsegmentation_tpu.models.template``):

- ``GenericStage``: the reference's stage skeleton with one of four convs
  (``pointnet``, ``anchor``, ``mlp_anchor``, ``diffusion_anchor``; JAX
  ``models/template.py:73-156``);
- ``TemplateSegModel``: three such stages over the pyramid with the pooled
  encoder and the tile + unpool decoder (JAX ``:27-70``), the
  operator-comparison harness of the ``template_*`` keys;
- ``SemanticPoolRefine``: two ECD stages over the class-pure pyramid, fed
  the first model's global features (JAX ``:159-187``).

Submodule and parameter names are the flax ones, so ``convert.py`` maps
the trees one to one; the inline anchor conv's trainable anchors
(``{name}_anchor``, [16, 3]) and its output Dense (``{name}_fc_out``) live
on the stage itself, as in flax.  Dtypes follow the JAX layers: each Dense
returns the compute dtype, and mixing it with float32 promotes as jnp
does."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops import anchors as anchor_gen
from ..ops import hierarchy as hier
from ..ops import neighbors as nb
from ..ops.types import Pyramid
from .ecd import (ECDStage, ECDStageSpec, MLPAnchorConv, _masked_global_max,
                  _masked_global_mean, _search_one)
from .layers import Dense, PointNetConv, add_growth, anchored_sum, growth
from .variants import DiffusionAnchorConv

CONVS = ("pointnet", "anchor", "mlp_anchor", "diffusion_anchor")

# the template dims (JAX models/template.py:37-44)
TEMPLATE_SPECS = (
    ECDStageSpec(radius=0.15, k=16, gxyz_dim=16, gc_dims=(16,),
                 gfc_dims=(8, 8, 8), final_dim=64, dxyz_scale=0.15),
    ECDStageSpec(radius=0.3, k=16, gxyz_dim=32, gc_dims=(32,),
                 gfc_dims=(32, 32, 32), final_dim=128, dxyz_scale=0.45),
    ECDStageSpec(radius=0.5, k=16, gxyz_dim=32, gc_dims=(32,),
                 gfc_dims=(32, 32, 32), final_dim=256, dxyz_scale=3.0),
)

# graph_conv_semantic_pool_v1's two stages (JAX models/template.py:164-169)
REFINE_SPECS = (
    ECDStageSpec(radius=0.1, k=16, gxyz_dim=16, gc_dims=(16, 16),
                 gfc_dims=(128, 128, 128), final_dim=256, dxyz_scale=0.2),
    ECDStageSpec(radius=1.5, k=16, gxyz_dim=16, gc_dims=(64, 64, 64, 64),
                 gfc_dims=(128, 128, 128), final_dim=256, dxyz_scale=3.0),
)
REFINE_EMBED = 256
ANCHORS = 16                # anchor_num of every template conv


class GenericStage(nn.Module):
    """One stage of the template (JAX ``models/template.py:73-156``): a
    band search (``band_neighbors_auto``, candidate pool 4k), an xyz conv
    (``xyz_gc``) on the level's raw float32 xyz, then per gc dim a ReLU
    Dense (``embed_{i}``) -> conv (``gc_{i}``) with concat growth, then a
    global growth FC (``gfc_{i}``, new first, ``final_gfc``) on ``[cfeats ‖
    dxyz / dxyz_scale]``.  Returns (fc_final, cfeats).

    The conv of width ``dim`` (``half = max(dim // 2, 4)``):
    ``pointnet`` a ``PointNetConv((half, half), dim)``; ``mlp_anchor`` an
    ``MLPAnchorConv`` with ``ANCHORS`` anchors; ``diffusion_anchor`` a
    ``DiffusionAnchorConv`` v2 with ``max(dim // ANCHORS, 1)`` embedding
    columns per anchor;
    ``anchor`` the inline v1 anchor conv: weights ``exp(-|sxyz - a|^2)``
    to the trainable anchors ``{name}_anchor`` (the sphere k-means, not a
    Glorot draw) over the valid slots, the anchor-weighted sum of the
    gathered features in float32, then ReLU ``{name}_fc_out``."""

    def __init__(self, spec: ECDStageSpec, in_dim: int,
                 conv: str = "pointnet",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if conv not in CONVS:
            raise ValueError(f"conv must be one of {CONVS}: {conv}")
        self.spec, self.conv = spec, conv
        self._add_conv("xyz_gc", 3, spec.gxyz_dim, dtype)
        w = spec.gxyz_dim + in_dim
        for i, gd in enumerate(spec.gc_dims):
            self.add_module(f"embed_{i}", Dense(w, gd, dtype=dtype))
            self._add_conv(f"gc_{i}", gd, gd, dtype)
            w += gd
        self.lf_width = w
        w = add_growth(self, "gfc_", w + 3, spec.gfc_dims, dtype)
        self.final_gfc = Dense(w, spec.final_dim, dtype=dtype)

    def _add_conv(self, name: str, in_dim: int, dim: int, dtype) -> None:
        half = max(dim // 2, 4)
        if self.conv == "anchor":
            anchors = torch.from_numpy(
                anchor_gen.cached_sphere_anchors(ANCHORS).T.copy())
            self.register_parameter(f"{name}_anchor", nn.Parameter(anchors))
            self.add_module(f"{name}_fc_out", Dense(ANCHORS * in_dim, dim,
                                                    dtype=dtype))
        elif self.conv == "pointnet":
            self.add_module(name, PointNetConv(in_dim, (half, half), dim,
                                               dtype=dtype))
        elif self.conv == "mlp_anchor":
            self.add_module(name, MLPAnchorConv(in_dim, (half, half), dim,
                                                ANCHORS, dtype=dtype))
        else:
            self.add_module(name, DiffusionAnchorConv(
                in_dim, 2, ANCHORS, dim, (half, half),
                embed_dim=max(dim // ANCHORS, 1), dtype=dtype))

    def _apply_conv(self, name: str, sxyz: torch.Tensor, f: torch.Tensor,
                    nbr) -> torch.Tensor:
        if self.conv != "anchor":
            return getattr(self, name)(sxyz, f, nbr)
        edge = nb.gather_neighbors(f, nbr)                     # [N,K,F]
        a = getattr(self, f"{name}_anchor")                    # [A,3]
        d2 = ((sxyz[:, :, None, :] - a[None, None]) ** 2).sum(-1)
        w = torch.exp(-d2) * nbr.mask[..., None].to(d2.dtype)  # [N,K,A]
        agg = anchored_sum(w, edge)                            # [N,A,F]
        return torch.relu(getattr(self, f"{name}_fc_out")(
            agg.reshape(agg.shape[0], -1)))

    def forward(self, xyz: torch.Tensor, mask: torch.Tensor,
                dxyz: torch.Tensor, feats: torch.Tensor,
                is_sorted: bool = False, chunk: int = 1024,
                windowed: bool = True):
        sp = self.spec
        nbr, sxyz_raw = _search_one(xyz, mask, sp.radius, sp.k, is_sorted,
                                    chunk, windowed)
        sxyz = sxyz_raw / sp.radius
        cfeats = torch.cat([self._apply_conv("xyz_gc", sxyz, xyz, nbr),
                            feats], dim=-1)
        for i in range(len(sp.gc_dims)):
            h = torch.relu(getattr(self, f"embed_{i}")(cfeats))
            conv = self._apply_conv(f"gc_{i}", sxyz, h, nbr)
            cfeats = torch.cat([cfeats, conv], dim=-1)
        fc_feats = growth(self, "gfc_", len(sp.gfc_dims),
                          torch.cat([cfeats, dxyz / sp.dxyz_scale], dim=-1),
                          True)
        return self.final_gfc(fc_feats), cfeats


def _tile_top(fc: torch.Tensor, lf: torch.Tensor,
              gvec: torch.Tensor) -> torch.Tensor:
    """``[gvec tiled ‖ fc ‖ lf]`` at the top level."""
    return torch.cat([gvec[None, :].expand(fc.shape[0], -1), fc, lf], dim=-1)


class TemplateSegModel(nn.Module):
    """``model_template`` (JAX ``models/template.py:27-70``): three
    ``GenericStage``s of one conv over the pyramid, max-pooled fc ‖
    avg-pooled cfeats between stages, the top's global max ‖ mean tiled
    back, and the unpool-concat decoder.  Returns (decoder output,
    [fc0 ‖ lf0]) for the unfactored ``SegClassifier``."""

    head_dim = None

    def __init__(self, feat_dim: int, conv: str, search_chunk: int = 1024,
                 dtype: Optional[torch.dtype] = None, windowed: bool = True):
        super().__init__()
        self.specs = TEMPLATE_SPECS
        self.search_chunk = search_chunk
        self.windowed = windowed
        self.dtype = dtype
        w, widths = feat_dim, []
        for s, sp in enumerate(self.specs):
            stage = GenericStage(sp, w, conv, dtype=dtype)
            self.add_module(f"stage{s}", stage)
            widths.append((sp.final_dim, stage.lf_width))
            w = sum(widths[-1])
        up = 2 * sum(widths[-1])
        for fc, lf in widths[-2::-1]:
            up += fc + lf
        self.out_width = up
        self.stage0_width = sum(widths[0])

    def forward(self, pyramid: Pyramid, feats: torch.Tensor):
        fcs, lfs = [], []
        cur = feats
        top = len(self.specs) - 1
        for s in range(top + 1):
            lvl = pyramid.levels[s]
            dxyz = pyramid.dxyz[s] if s == 0 else lvl.xyz
            fc, lf = getattr(self, f"stage{s}")(
                lvl.xyz, lvl.mask, dxyz, cur,
                is_sorted=pyramid.level_sorted(s), chunk=self.search_chunk,
                windowed=self.windowed)
            fcs.append(fc)
            lfs.append(lf)
            if s < top:
                cur = torch.cat([hier.pool_max(fc, pyramid, s),
                                 hier.pool_avg(lf, pyramid, s)], dim=-1)
        tmask = pyramid.levels[top].mask
        up = _tile_top(fcs[top], lfs[top], torch.cat(
            [_masked_global_max(fcs[top], tmask),
             _masked_global_mean(lfs[top], tmask)], dim=0))
        for s in range(top - 1, -1, -1):
            up = torch.cat([hier.unpool(up, pyramid, s), fcs[s], lfs[s]],
                           dim=-1)
        return up, torch.cat([fcs[0], lfs[0]], dim=-1)


class SemanticPoolRefine(nn.Module):
    """``graph_conv_semantic_pool_v1`` (JAX ``models/template.py:
    159-187``): the first model's semantic features embedded to 256
    (``semantic_embed``, ReLU), an ECD stage on the points, max-pooled into
    the class-pure voxels, an ECD stage there (conditioned on the voxel
    xyz), its global max tiled back, unpool-concat.  Returns (up0,
    [lf0 ‖ fc0]): the local features in the reverse of the template's
    order.  ``global_width`` and ``local_width`` size the cascade's
    head."""

    def __init__(self, in_dim: int, search_chunk: int = 1024,
                 dtype: Optional[torch.dtype] = None, windowed: bool = True):
        super().__init__()
        sp0, sp1 = REFINE_SPECS
        self.search_chunk = search_chunk
        self.windowed = windowed
        self.semantic_embed = Dense(in_dim, REFINE_EMBED, dtype=dtype)
        self.stage0 = ECDStage(sp0, REFINE_EMBED, dtype=dtype)
        self.stage1 = ECDStage(sp1, sp0.final_dim, dtype=dtype)
        lf0, lf1 = self.stage0.lf_width, self.stage1.lf_width
        self.global_width = 2 * sp1.final_dim + lf1 + sp0.final_dim + lf0
        self.local_width = lf0 + sp0.final_dim

    def forward(self, pyramid: Pyramid, sem_feats: torch.Tensor):
        feats = torch.relu(self.semantic_embed(sem_feats))
        lvl0, lvl1 = pyramid.levels[0], pyramid.levels[1]
        fc0, lf0 = self.stage0(lvl0.xyz, lvl0.mask, pyramid.dxyz[0], feats,
                               is_sorted=pyramid.level_sorted(0),
                               chunk=self.search_chunk,
                               windowed=self.windowed)
        pooled = hier.pool_max(fc0, pyramid, 0)
        fc1, lf1 = self.stage1(lvl1.xyz, lvl1.mask, lvl1.xyz, pooled,
                               is_sorted=pyramid.level_sorted(1),
                               chunk=self.search_chunk,
                               windowed=self.windowed)
        up1 = _tile_top(fc1, lf1, _masked_global_max(fc1, lvl1.mask))
        up0 = torch.cat([hier.unpool(up1, pyramid, 0), fc0, lf0], dim=-1)
        return up0, torch.cat([lf0, fc0], dim=-1)
