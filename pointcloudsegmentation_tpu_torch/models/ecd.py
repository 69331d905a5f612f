"""Edge-conditioned diffusion (ECD) and PGNet model families (mirror of
``pointcloudsegmentation_tpu.models.ecd``):

- ``ECDSegModel`` over ``ECDStage``s: the ECD nets of ScanNet and S3DIS and
  pgnet_v3/v4/v5 (JAX ``models/ecd.py:120-201``);
- ``PGNetHybrid`` (pgnet_v8): pairs of pointnet conv -> ``MLPAnchorConv``
  (JAX ``:204-339``);
- ``PGNetV6`` over ``ECDStageV2`` (JAX ``:343-456``);
- ``PGNetV7``: a pointnet conv opener, then ``ECDFeatsV4`` chains (JAX
  ``:460-558``).

Each search is ``search.band_neighbors_auto`` with its per-point overflow
slots (the JAX default ``ov_pool_size=0``) and the JAX call's candidate
pool (4k), over query chunks of ``search_chunk`` rows: each row is scored
on its own, so the chunk only bounds the [chunk, N] score matrix (the JAX
stages use chunks of 1024 whatever ``search_chunk`` says).  Every encoder
returns (decoder output, stage-0 features) for the unfactored
``SegClassifier`` and exposes ``out_width``, ``stage0_width`` and
``head_dim = None`` for ``SegmentationModel``.  Submodules keep the
flax names, including ``ECDStageV2``'s ``(fc, lf)`` binding, which the
reference swaps."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import hierarchy as hier
from ..ops import neighbors as nb
from ..ops import search
from ..ops.types import Pyramid
from ..utils import profiling
from .layers import (Dense, ECDConv, PointNetConv, PointNetPoolMLP,
                     add_growth, growth)
from .variants import ECDFeatsV2, ECDFeatsV4, ECDXyzV2, l2_normalise


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
    with profiling.span("pcs.search"):
        (res,) = search.band_neighbors_auto(
            xyz, mask, ((0.0, radius, k),), cand_k=min(4 * k, xyz.shape[0]),
            chunk=chunk, return_sxyz=True, sorted=is_sorted,
            windowed=windowed)
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

# pgnet_model_v3/v4/v5 (model_pgnet.py:155-311)
PGNET_V3_SPEC = (
    ECDStageSpec(radius=0.15, k=16, gxyz_dim=16, gc_dims=(16, 16),
                 gfc_dims=(8, 8, 8), final_dim=64, dxyz_scale=0.15),
    ECDStageSpec(radius=0.3, k=16, gxyz_dim=16, gc_dims=(32,) * 9,
                 gfc_dims=(32, 32, 32), final_dim=256, dxyz_scale=0.45,
                 use_dxyz=True),
    ECDStageSpec(radius=0.5, k=16, gxyz_dim=16, gc_dims=(32,) * 9,
                 gfc_dims=(32, 32, 32), final_dim=512, dxyz_scale=3.0),
)

PGNET_V4_SPEC = (
    ECDStageSpec(radius=0.15, k=16, gxyz_dim=16, gc_dims=(8,) * 4,
                 gfc_dims=(8, 8, 8), final_dim=64, dxyz_scale=0.15),
    ECDStageSpec(radius=0.3, k=16, gxyz_dim=16, gc_dims=(16,) * 18,
                 gfc_dims=(16,) * 6, final_dim=256, dxyz_scale=0.45,
                 use_dxyz=True),
    ECDStageSpec(radius=0.5, k=16, gxyz_dim=16, gc_dims=(16,) * 18,
                 gfc_dims=(16,) * 6, final_dim=512, dxyz_scale=3.0),
)

PGNET_V5_SPEC = (
    ECDStageSpec(radius=0.15, k=16, gxyz_dim=16, gc_dims=(16,),
                 gfc_dims=(8, 8, 8), final_dim=64, dxyz_scale=0.15),
    ECDStageSpec(radius=0.3, k=16, gxyz_dim=16, gc_dims=(32, 32, 32),
                 gfc_dims=(32, 32, 32), final_dim=256, dxyz_scale=0.45,
                 use_dxyz=True),
    ECDStageSpec(radius=0.5, k=16, gxyz_dim=16, gc_dims=(32, 32, 32),
                 gfc_dims=(32, 32, 32), final_dim=512, dxyz_scale=3.0),
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


class MLPAnchorConv(nn.Module):
    """``mlp_anchor_conv`` (JAX ``models/ecd.py:204-236``): anchor weights
    from a growth MLP (``fc_weights_{i}``, new first,
    ``fc_weights_final``) on ``[sxyz ‖ f_j - f_i]``, l2-normalised and
    rescaled by the trainable ``edge_weights_trans`` [1, 1, A], masked,
    then the anchor-weighted sum of the neighbor features
    (``nka,nkf->naf``, a batched matrix product, as JAX computes it outside
    any kernel), divided by the valid count, then leaky-ReLU ``fc_out``."""

    def __init__(self, in_dim: int, weights_dims, out_dim: int,
                 anchor_num: int, l2_norm: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.l2_norm = l2_norm
        self.n_w = len(weights_dims)
        w = add_growth(self, "fc_weights_", in_dim + 3, weights_dims, dtype)
        self.fc_weights_final = Dense(w, anchor_num, dtype=dtype)
        if l2_norm:
            self.edge_weights_trans = nn.Parameter(
                torch.ones(1, 1, anchor_num))
        self.fc_out = Dense(anchor_num * in_dim, out_dim, dtype=dtype)

    def forward(self, sxyz: torch.Tensor, feats: torch.Tensor,
                nbr) -> torch.Tensor:
        edge = nb.gather_neighbors(feats, nbr)                 # [N,K,F]
        ew = self.fc_weights_final(growth(
            self, "fc_weights_", self.n_w,
            torch.cat([sxyz, edge - feats[:, None, :]], dim=-1), True))
        if self.l2_norm:
            ew = l2_normalise(ew) * self.edge_weights_trans
        w = ew * nbr.mask[..., None].to(ew.dtype)              # [N,K,A]
        dt = torch.promote_types(w.dtype, edge.dtype)
        agg = torch.bmm(w.to(dt).transpose(1, 2), edge.to(dt))  # [N,A,F]
        agg = agg.reshape(agg.shape[0], -1)
        agg = agg / nbr.counts()[:, None].clamp(min=1.0)
        return F.leaky_relu(self.fc_out(agg), 0.01)


@dataclass(frozen=True)
class PGPairSpec:
    """One (pointnet_conv, mlp_anchor_conv) pair of pgnet_model_v8."""

    radius: float
    k: int
    pn_dims: Tuple[int, ...]
    pn_out: int
    aw_dims: Tuple[int, ...]
    a_out: int
    anchors: int


@dataclass(frozen=True)
class PGStageSpec:
    pairs: Tuple[PGPairSpec, ...]
    pool_dims: Optional[Tuple[int, ...]] = None
    pool_out: int = 0


# pgnet_model_v8 exact dims (model_pgnet.py:1042-1131)
PGNET_V8_SPEC = (
    PGStageSpec(pairs=(
        PGPairSpec(0.15, 16, (8,), 8, (16,), 16, 9),
        PGPairSpec(0.15, 16, (8,), 8, (16,), 16, 9),
        PGPairSpec(0.1, 12, (16,), 16, (32,), 32, 9),
        PGPairSpec(0.1, 12, (16,), 16, (32,), 32, 9),
    ), pool_dims=(16, 16), pool_out=64),
    PGStageSpec(pairs=(
        PGPairSpec(0.6, 16, (16,), 16, (32,), 32, 9),
        PGPairSpec(0.6, 16, (16,), 16, (32,), 32, 9),
        PGPairSpec(0.3, 12, (16,), 16, (24,), 48, 12),
        PGPairSpec(0.3, 12, (20,), 20, (32,), 64, 12),
    ), pool_dims=(32, 32), pool_out=128),
    PGStageSpec(pairs=(
        PGPairSpec(0.9, 16, (24,), 24, (32,), 64, 12),
        PGPairSpec(0.9, 16, (24,), 24, (48,), 96, 16),
    )),
)


class _GrowthGlobalDecoder(nn.Module):
    """What ``PGNetHybrid`` and ``PGNetV7`` share: the global growth MLP
    (``global_{i}``, new columns last, ``global_out``) on [top xyz ‖ the
    features before the top stage's last conv], and the unpool-concat
    decoder over the stages' features (JAX ``models/ecd.py:322-339,
    541-558``)."""

    head_dim = None

    def _add_global(self, in_dim: int, dims, out: int, dtype) -> None:
        self.n_global = len(dims)
        self.global_out = Dense(add_growth(self, "global_", in_dim, dims,
                                           dtype), out, dtype=dtype)

    def _widths(self, stage_widths, global_out: int) -> None:
        up = global_out + stage_widths[-1]
        for w in stage_widths[-2::-1]:
            up += w
        self.out_width = up
        self.stage0_width = stage_widths[0]

    def _decode(self, pyramid: Pyramid, stage_feats, prev: torch.Tensor):
        top = len(stage_feats) - 1
        g = growth(self, "global_", self.n_global,
                   torch.cat([pyramid.levels[top].xyz, prev], dim=-1), False)
        up = torch.cat([self.global_out(g), stage_feats[top]], dim=-1)
        for s in range(top - 1, -1, -1):
            up = torch.cat([hier.unpool(up, pyramid, s), stage_feats[s]],
                           dim=-1)
        return up, stage_feats[0]


class PGNetHybrid(_GrowthGlobalDecoder):
    """pgnet_model_v8 (JAX ``models/ecd.py:280-339``): per stage, pairs of
    pointnet conv (``pointnet{i}``) -> ``MLPAnchorConv`` (``anchor_conv{i}``)
    with ``[feats ‖ anchor out ‖ pointnet out]`` growth, one search per
    distinct (radius, k) of the stage; a pointnet pool (``pool{s}``)
    between stages; the global growth MLP -> 256; unpool decoder."""

    def __init__(self, feat_dim: int, specs=PGNET_V8_SPEC,
                 global_dims=(64, 64, 128), global_out: int = 256,
                 search_chunk: int = 1024,
                 dtype: Optional[torch.dtype] = None, windowed: bool = True):
        super().__init__()
        self.specs = tuple(specs)
        self.search_chunk = search_chunk
        self.windowed = windowed
        self.dtype = dtype
        w = prev_w = feat_dim
        i = 0
        stage_widths = []
        for s, stage in enumerate(self.specs):
            for p in stage.pairs:
                prev_w = w
                self.add_module(f"pointnet{i}", PointNetConv(
                    w, p.pn_dims, p.pn_out, dtype=dtype))
                self.add_module(f"anchor_conv{i}", MLPAnchorConv(
                    p.pn_out, p.aw_dims, p.a_out, p.anchors, dtype=dtype))
                w += p.a_out + p.pn_out
                i += 1
            stage_widths.append(w)
            if stage.pool_dims is not None:
                self.add_module(f"pool{s}", PointNetPoolMLP(
                    w, stage.pool_dims, stage.pool_out, dtype=dtype))
                w = stage.pool_out
        self._add_global(3 + prev_w, global_dims, global_out, dtype)
        self._widths(stage_widths, global_out)

    def forward(self, pyramid: Pyramid, feats: torch.Tensor):
        stage_feats = []
        i = 0
        prev = feats
        for s, stage in enumerate(self.specs):
            lvl = pyramid.levels[s]
            cache: Dict = {}
            for p in stage.pairs:
                key = (p.radius, p.k)
                if key not in cache:
                    cache[key] = _search_one(
                        lvl.xyz, lvl.mask, p.radius, p.k,
                        pyramid.level_sorted(s), self.search_chunk,
                        self.windowed)
                nbr, sxyz_raw = cache[key]
                sxyz = sxyz_raw / p.radius
                prev = feats
                pn = getattr(self, f"pointnet{i}")(sxyz, feats, nbr)
                an = getattr(self, f"anchor_conv{i}")(sxyz, pn, nbr)
                feats = torch.cat([feats, an, pn], dim=-1)
                i += 1
            stage_feats.append(feats)
            if stage.pool_dims is not None:
                pf = getattr(self, f"pool{s}")(pyramid.dxyz[s], feats)
                feats = hier.pool_max(pf, pyramid, s)
        return self._decode(pyramid, stage_feats, prev)


@dataclass(frozen=True)
class V2StageSpec:
    """ecd_stage_v2 hyperparameters (model_pgnet.py:455-483)."""

    radius: float
    k: int
    # xyz conv: feats_dims, final_feats_dim, diffusion_dims, trans_dims, out
    xyz_param: Tuple
    # per feats conv: (embed_dim, diffusion_dims, trans_dims, out_dim)
    feats_params: Tuple[Tuple, ...]
    embed_dims: Tuple[int, ...]
    final_dim: int
    sxyz_scale: float
    dxyz_scale: float


# pgnet_model_v6 exact params (model_pgnet.py:485-549)
PGNET_V6_SPEC = (
    V2StageSpec(radius=0.15, k=16,
                xyz_param=((8, 8), 16, (8, 8), (8, 8), 32),
                feats_params=((16, (8, 8), (8, 8), 32),
                              (16, (8, 8), (8, 8), 32)),
                embed_dims=(16, 16, 16), final_dim=128,
                sxyz_scale=3.0 / 0.15, dxyz_scale=3.0 / 0.15),
    V2StageSpec(radius=0.3, k=16,
                xyz_param=((16, 16), 32, (16, 16), (16, 16), 32),
                feats_params=((32, (16, 16), (16, 16), 32),) * 3,
                embed_dims=(32, 32, 32), final_dim=256,
                sxyz_scale=3.0 / 0.3, dxyz_scale=3.0 / 0.45),
    V2StageSpec(radius=0.5, k=16,
                xyz_param=((16, 16), 32, (16, 16), (16, 16), 32),
                feats_params=((48, (16, 16), (16, 16), 48),) * 3,
                embed_dims=(64, 64, 64, 128), final_dim=512,
                sxyz_scale=3.0 / 0.9, dxyz_scale=3.0 / 3.0),
)


class ECDStageV2(nn.Module):
    """``ecd_stage_v2`` (JAX ``models/ecd.py:379-414``): an ``ECDXyzV2``
    opener (``xyz``), ``ECDFeatsV2`` chains (``feats_{i}``) with concat
    growth, a global growth FC (``global_{i}``, new first,
    ``final_global``) on ``[cfeats ‖ dxyz * dxyz_scale]``.  Returns
    (cfeats, fc_final), which ``PGNetV6`` binds as (fc, lf), as the
    reference does."""

    def __init__(self, spec: V2StageSpec, in_dim: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.spec = spec
        fd, ffd, dd, td, od = spec.xyz_param
        self.xyz = ECDXyzV2(fd, ffd, dd, td, od, dtype=dtype)
        w = in_dim + od
        for i, (ed, fdd, ftd, fod) in enumerate(spec.feats_params):
            self.add_module(f"feats_{i}", ECDFeatsV2(w, ed, fdd, ftd, fod,
                                                     dtype=dtype))
            w += fod
        self.cfeats_width = w
        w = add_growth(self, "global_", w + 3, spec.embed_dims, dtype)
        self.final_global = Dense(w, spec.final_dim, dtype=dtype)

    def forward(self, xyz: torch.Tensor, mask: torch.Tensor,
                dxyz: torch.Tensor, feats: torch.Tensor,
                is_sorted: bool = False, chunk: int = 1024,
                windowed: bool = True):
        sp = self.spec
        nbr, sxyz_raw = _search_one(xyz, mask, sp.radius, sp.k, is_sorted,
                                    chunk, windowed)
        sxyz = sxyz_raw * sp.sxyz_scale
        cfeats = torch.cat([feats, self.xyz(sxyz, nbr, mask)], dim=-1)
        for i in range(len(sp.feats_params)):
            v = getattr(self, f"feats_{i}")(sxyz, cfeats, nbr, mask)
            cfeats = torch.cat([cfeats, v], dim=-1)
        fc_feats = growth(self, "global_", len(sp.embed_dims),
                          torch.cat([cfeats, dxyz * sp.dxyz_scale], dim=-1),
                          True)
        return cfeats, self.final_global(fc_feats)


class PGNetV6(nn.Module):
    """pgnet_model_v6 (JAX ``models/ecd.py:417-456``): three
    ``ECDStageV2`` stages; between them the max-pooled cfeats and a cascade
    of avg-pooled raw input features; the top's global max of cfeats tiled
    back; unpool-concat decoder.  Returns (up0, lf0)."""

    head_dim = None

    def __init__(self, feat_dim: int, specs=PGNET_V6_SPEC,
                 search_chunk: int = 1024,
                 dtype: Optional[torch.dtype] = None, windowed: bool = True):
        super().__init__()
        self.specs = tuple(specs)
        self.search_chunk = search_chunk
        self.windowed = windowed
        self.dtype = dtype
        s0 = ECDStageV2(self.specs[0], feat_dim, dtype=dtype)
        s1 = ECDStageV2(self.specs[1], feat_dim + s0.cfeats_width,
                        dtype=dtype)
        s2 = ECDStageV2(self.specs[2], s1.cfeats_width + feat_dim,
                        dtype=dtype)
        self.stage0, self.stage1, self.stage2 = s0, s1, s2
        up = 2 * s2.cfeats_width + self.specs[2].final_dim
        for st, sp in ((s1, self.specs[1]), (s0, self.specs[0])):
            up += st.cfeats_width + sp.final_dim
        self.out_width = up
        self.stage0_width = self.specs[0].final_dim

    def forward(self, pyramid: Pyramid, feats: torch.Tensor):
        lvl0, lvl1, lvl2 = pyramid.levels[:3]
        fc0, lf0 = self.stage0(lvl0.xyz, lvl0.mask, pyramid.dxyz[0], feats,
                               is_sorted=pyramid.level_sorted(0),
                               chunk=self.search_chunk,
                               windowed=self.windowed)
        lf0_avg = hier.pool_avg(feats, pyramid, 0)
        ifeats0 = torch.cat([lf0_avg, hier.pool_max(fc0, pyramid, 0)],
                            dim=-1)
        fc1, lf1 = self.stage1(lvl1.xyz, lvl1.mask, pyramid.dxyz[1], ifeats0,
                               is_sorted=pyramid.level_sorted(1),
                               chunk=self.search_chunk,
                               windowed=self.windowed)
        lf1_avg = hier.pool_avg(lf0_avg, pyramid, 1)
        ifeats1 = torch.cat([hier.pool_max(fc1, pyramid, 1), lf1_avg],
                            dim=-1)
        fc2, lf2 = self.stage2(lvl2.xyz, lvl2.mask, lvl2.xyz, ifeats1,
                               is_sorted=pyramid.level_sorted(2),
                               chunk=self.search_chunk,
                               windowed=self.windowed)
        gvec = _masked_global_max(fc2, lvl2.mask)
        up2 = torch.cat([gvec[None, :].expand(fc2.shape[0], -1), fc2, lf2],
                        dim=-1)
        up1 = torch.cat([hier.unpool(up2, pyramid, 1), fc1, lf1], dim=-1)
        up0 = torch.cat([hier.unpool(up1, pyramid, 0), fc0, lf0], dim=-1)
        return up0, lf0


@dataclass(frozen=True)
class V7ConvSpec:
    """One conv of pgnet_model_v7: 'pn' = pointnet_conv, 'ecd' =
    ecd_feats_v4."""

    kind: str
    radius: float
    k: int
    dims: Tuple[int, ...]
    out: int


@dataclass(frozen=True)
class V7StageSpec:
    convs: Tuple[V7ConvSpec, ...]
    pool_dims: Optional[Tuple[int, ...]] = None
    pool_out: int = 0


# pgnet_model_v7 exact dims (model_pgnet.py:920-996)
PGNET_V7_SPEC = (
    V7StageSpec(convs=(
        V7ConvSpec("pn", 0.15, 16, (4, 4, 8), 16),
        V7ConvSpec("ecd", 0.15, 16, (16,), 16),
        V7ConvSpec("ecd", 0.1, 16, (32,), 32),
        V7ConvSpec("ecd", 0.1, 16, (32,), 32),
    ), pool_dims=(16, 16), pool_out=64),
    V7StageSpec(convs=(
        V7ConvSpec("pn", 0.6, 16, (8, 8, 16), 32),
        V7ConvSpec("ecd", 0.6, 16, (32,), 32),
        V7ConvSpec("ecd", 0.3, 16, (32,), 32),
        V7ConvSpec("ecd", 0.3, 16, (48,), 48),
        V7ConvSpec("ecd", 0.3, 16, (64,), 64),
    ), pool_dims=(32, 32), pool_out=128),
    V7StageSpec(convs=(
        V7ConvSpec("ecd", 0.9, 16, (64,), 64),
        V7ConvSpec("ecd", 0.9, 16, (96,), 96),
    )),
)


class PGNetV7(_GrowthGlobalDecoder):
    """pgnet_model_v7 (JAX ``models/ecd.py:500-558``): per stage, a
    pointnet conv opener (``feats{i}``) then ``ECDFeatsV4`` chains
    (``ecd{i}``) at two radii with concat growth, one search per distinct
    (radius, k); a pointnet pool between stages; the global growth MLP ->
    384; unpool decoder."""

    def __init__(self, feat_dim: int, specs=PGNET_V7_SPEC,
                 global_dims=(64, 64, 64, 128), global_out: int = 384,
                 search_chunk: int = 1024,
                 dtype: Optional[torch.dtype] = None, windowed: bool = True):
        super().__init__()
        self.specs = tuple(specs)
        self.search_chunk = search_chunk
        self.windowed = windowed
        self.dtype = dtype
        w = prev_w = feat_dim
        i = 0
        stage_widths = []
        for s, stage in enumerate(self.specs):
            for c in stage.convs:
                prev_w = w
                if c.kind == "pn":
                    self.add_module(f"feats{i}", PointNetConv(
                        w, c.dims, c.out, dtype=dtype))
                else:
                    self.add_module(f"ecd{i}", ECDFeatsV4(
                        w, c.dims, c.out, dtype=dtype))
                w += c.out
                i += 1
            stage_widths.append(w)
            if stage.pool_dims is not None:
                self.add_module(f"pool{s}", PointNetPoolMLP(
                    w, stage.pool_dims, stage.pool_out, dtype=dtype))
                w = stage.pool_out
        self._add_global(3 + prev_w, global_dims, global_out, dtype)
        self._widths(stage_widths, global_out)

    def forward(self, pyramid: Pyramid, feats: torch.Tensor):
        stage_feats = []
        i = 0
        prev = feats
        for s, stage in enumerate(self.specs):
            lvl = pyramid.levels[s]
            cache: Dict = {}
            for c in stage.convs:
                key = (c.radius, c.k)
                if key not in cache:
                    cache[key] = _search_one(
                        lvl.xyz, lvl.mask, c.radius, c.k,
                        pyramid.level_sorted(s), self.search_chunk,
                        self.windowed)
                nbr, sxyz_raw = cache[key]
                sxyz = sxyz_raw / c.radius
                prev = feats
                name = f"feats{i}" if c.kind == "pn" else f"ecd{i}"
                out = getattr(self, name)(sxyz, feats, nbr)
                feats = torch.cat([feats, out], dim=-1)
                i += 1
            stage_feats.append(feats)
            if stage.pool_dims is not None:
                pf = getattr(self, f"pool{s}")(pyramid.dxyz[s], feats)
                feats = hier.pool_max(pf, pyramid, s)
        return self._decode(pyramid, stage_feats, prev)
