"""The edge-conditioned diffusion (ECD) encoder: a frozen copy of the port's
``models/ecd.py`` (``ECDSegModel`` over ``ECDStage``s with the S3DIS spec).
Each search is ``search.band_neighbors_auto`` with per-point overflow slots
and a candidate pool of 4k."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from . import hierarchy as hier
from . import search
from .types import Pyramid
from .layers import Dense, ECDConv, add_growth, growth


def _masked_global_max(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Max over valid rows; -1e30 where no row is valid (JAX :36-38)."""
    return torch.where(mask[:, None], x, torch.full_like(x, -1e30)
                       ).amax(dim=0)


def _masked_global_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over valid rows (JAX :41-43)."""
    m = mask[:, None].to(x.dtype)
    return (x * m).sum(dim=0) / m.sum().clamp(min=1.0)


def _search_one(xyz: torch.Tensor, mask: torch.Tensor, radius: float,
                k: int, is_sorted: bool, chunk: int, windowed: bool = True):
    """One band (0, radius, k) with the JAX stages' candidate pool of 4k:
    (neighborhood, raw sxyz [N, K+Ko, 3]); ``windowed=False`` takes the
    global search on every level."""
    (res,) = search.band_neighbors_auto(
        xyz, mask, ((0.0, radius, k),), cand_k=min(4 * k, xyz.shape[0]),
        chunk=chunk, return_sxyz=True, sorted=is_sorted, windowed=windowed)
    return res


@dataclass(frozen=True)
class ECDStageSpec:
    radius: float
    k: int
    gxyz_dim: int = 16
    gc_dims: Tuple[int, ...] = (16, 16)
    gfc_dims: Tuple[int, ...] = (8, 8, 8)
    final_dim: int = 64
    dxyz_scale: float = 1.0  # voxel_size divisor applied to dxyz
    # condition the global FC on the level's dxyz instead of raw xyz on
    # stages > 0 (pgnet_model_v3/v4/v5 stage 1)
    use_dxyz: bool = False


# graph_conv_pool_edge_simp_2layers (model_pooling.py:268-318)
SCANNET_ECD_SPEC = (
    ECDStageSpec(radius=0.15, k=16, gxyz_dim=16, gc_dims=(16, 16),
                 gfc_dims=(8, 8, 8), final_dim=64, dxyz_scale=0.15),
    ECDStageSpec(radius=0.3, k=16, gxyz_dim=16, gc_dims=(32,) * 9,
                 gfc_dims=(32, 32, 32), final_dim=256, dxyz_scale=0.45),
    ECDStageSpec(radius=0.5, k=16, gxyz_dim=16, gc_dims=(32,) * 9,
                 gfc_dims=(32, 32, 32), final_dim=512, dxyz_scale=3.0),
)

# graph_conv_pool_edge_simp_2layers_s3d (model_pooling.py:322-369)
S3DIS_ECD_SPEC = (
    ECDStageSpec(radius=0.15, k=16, gxyz_dim=16, gc_dims=(16,),
                 gfc_dims=(16, 16, 16), final_dim=64, dxyz_scale=0.075),
    ECDStageSpec(radius=0.3, k=16, gxyz_dim=16, gc_dims=(16, 16, 32, 32),
                 gfc_dims=(32, 32, 32), final_dim=128, dxyz_scale=0.225),
    ECDStageSpec(radius=0.5, k=16, gxyz_dim=16, gc_dims=(32, 32, 64, 64),
                 gfc_dims=(64, 64, 64), final_dim=384, dxyz_scale=1.5),
)

class ECDStage(nn.Module):
    """One ECD stage (JAX ``models/ecd.py:120-155``): an xyz-only ECD conv
    (``xyz_gc``), then per gc dim a ReLU Dense (``fc_{i}``) -> ECD conv
    (``gc_{i}``) with concat growth, then a global growth FC (``gfc_{i}``,
    new first, ``final_gfc``) on ``[cfeats ‖ dxyz / dxyz_scale]``.  Returns
    (fc_final, cfeats); ``lf_width`` is cfeats' width."""

    def __init__(self, spec: ECDStageSpec, in_dim: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.spec = spec
        g = spec.gxyz_dim
        self.xyz_gc = ECDConv(0, (g // 2, g // 2), (g // 2, g // 2), g,
                              use_xyz_only=True, dtype=dtype)
        w = g + in_dim
        for i, fdim in enumerate(spec.gc_dims):
            self.add_module(f"fc_{i}", Dense(w, fdim, dtype=dtype))
            self.add_module(f"gc_{i}", ECDConv(
                fdim, (fdim // 2, fdim // 2), (fdim // 2, fdim // 2), fdim,
                dtype=dtype))
            w += fdim
        self.lf_width = w
        w = add_growth(self, "gfc_", w + 3, spec.gfc_dims, dtype)
        self.final_gfc = Dense(w, spec.final_dim, dtype=dtype)

    def forward(self, xyz: torch.Tensor, mask: torch.Tensor,
                dxyz: torch.Tensor, feats: torch.Tensor,
                is_sorted: bool = False, chunk: int = 1024,
                windowed: bool = True):
        sp = self.spec
        nbr, sxyz_raw = _search_one(xyz, mask, sp.radius, sp.k, is_sorted,
                                    chunk, windowed)
        sxyz = sxyz_raw / sp.radius
        cfeats = torch.cat([self.xyz_gc(sxyz, None, nbr), feats], dim=-1)
        for i in range(len(sp.gc_dims)):
            h = torch.relu(getattr(self, f"fc_{i}")(cfeats))
            conv = getattr(self, f"gc_{i}")(sxyz, h, nbr)
            cfeats = torch.cat([cfeats, conv], dim=-1)
        fc_feats = growth(self, "gfc_", len(sp.gfc_dims),
                          torch.cat([cfeats, dxyz / sp.dxyz_scale], dim=-1),
                          True)
        return self.final_gfc(fc_feats), cfeats


class ECDSegModel(nn.Module):
    """Three ECD stages over the pyramid (JAX ``models/ecd.py:158-201``):
    max-pooled fc and avg-pooled cfeats between stages, global max/mean at
    the top, tile + unpool-concat decoder.  Returns (decoder output,
    [fc0 ‖ lf0])."""

    head_dim = None

    def __init__(self, feat_dim: int, specs=SCANNET_ECD_SPEC,
                 search_chunk: int = 1024,
                 dtype: Optional[torch.dtype] = None, windowed: bool = True):
        super().__init__()
        self.specs = tuple(specs)
        self.search_chunk = search_chunk
        self.windowed = windowed
        self.dtype = dtype
        w = feat_dim
        widths = []
        for s, sp in enumerate(self.specs):
            stage = ECDStage(sp, w, dtype=dtype)
            self.add_module(f"stage{s}", stage)
            widths.append((sp.final_dim, stage.lf_width))
            w = sum(widths[-1])
        fc_top, lf_top = widths[-1]
        up = 2 * (fc_top + lf_top)
        for fc, lf in widths[-2::-1]:
            up += fc + lf
        self.out_width = up
        self.stage0_width = sum(widths[0])

    def forward(self, pyramid: Pyramid, feats: torch.Tensor):
        n_stages = len(self.specs)
        fcs, lfs = [], []
        cur = feats
        for s, sp in enumerate(self.specs):
            lvl = pyramid.levels[s]
            # the rule of JAX models/ecd.py:177
            use_d = s == 0 or (sp.use_dxyz and s < len(pyramid.dxyz))
            dxyz = pyramid.dxyz[s] if use_d else lvl.xyz
            fc, lf = getattr(self, f"stage{s}")(
                lvl.xyz, lvl.mask, dxyz, cur,
                is_sorted=pyramid.level_sorted(s), chunk=self.search_chunk,
                windowed=self.windowed)
            fcs.append(fc)
            lfs.append(lf)
            if s < n_stages - 1:
                cur = torch.cat([hier.pool_max(fc, pyramid, s),
                                 hier.pool_avg(lf, pyramid, s)], dim=-1)
        top = n_stages - 1
        tmask = pyramid.levels[top].mask
        gvec = torch.cat([_masked_global_max(fcs[top], tmask),
                          _masked_global_mean(lfs[top], tmask)], dim=0)
        up = gvec[None, :].expand(fcs[top].shape[0], -1)
        up = torch.cat([up, fcs[top], lfs[top]], dim=-1)
        for s in range(top - 1, -1, -1):
            up = torch.cat([hier.unpool(up, pyramid, s), fcs[s], lfs[s]],
                           dim=-1)
        return up, torch.cat([fcs[0], lfs[0]], dim=-1)




def build_encoder(cfg: Dict, dtype: Optional[torch.dtype]) -> nn.Module:
    """The encoder of a configuration file whose ``encoder`` is ``ecd``:
    the S3DIS spec with the file's search chunk."""
    return ECDSegModel(cfg["feat_dim"], specs=S3DIS_ECD_SPEC,
                       search_chunk=cfg["search_chunk"], dtype=dtype)
