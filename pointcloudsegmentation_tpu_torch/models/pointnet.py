"""PointNet-conv segmentation encoders (mirror of
``pointcloudsegmentation_tpu.models.pointnet``'s ``PointNetSegEncoder`` and
its archs: the flagship, ScanNet, the two Semantic3D nets, the noconcat
baseline, the deconv net and the embed-only ablation; and of its
PointNet++ baseline, ``PointNet2Baseline``, at the end of the file).

Per stage (= pyramid level): one shared multi-band search, then each conv
(optional fc_embed bottleneck -> PointNetConvFast, or the plain-MLP
PointNetConv of a noconcat spec -> concat growth; or an xyz-only
PointNetConv whose output replaces the features); between stages a voxel
pool block; a global growth MLP at the top.  Semantic3D's pre-stage runs a
conv on level 1 and prepends its unpooled output to the level-0 features.
The decoder unpools back down: with ``head_dim`` the factored head projects
each stage at its own level and unpools head_dim-wide sums; without it the
encoder returns the wide concat (or deconv) decoder output."""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import hierarchy as hier
from ..ops import search
from ..ops.types import Pyramid
from ..utils import profiling
from .ecd import MLPAnchorConv
from .fast_conv import PointNetConvFast
from .layers import (Dense, FCEmbed, GrowthMLP, PointNetConv,
                     PointNetPoolMLP)


@dataclass(frozen=True)
class ConvSpec:
    """One pointnet_conv application inside a stage."""

    radius: float
    k: int
    min_radius: float = 0.0
    embed: Optional[int] = None       # fc_embed bottleneck dim (None = skip)
    fc_dims: Tuple[int, ...] = (8, 8, 16)
    out: int = 32
    nofeats: bool = False             # xyz-only first conv (scannet variant)
    # plain-MLP edge stack without the growth concat
    # (pointnet_conv_noconcat, model_pointnet.py:41-54)
    noconcat: bool = False


@dataclass(frozen=True)
class StageSpec:
    convs: Tuple[ConvSpec, ...]
    rescale: float                    # sxyz divisor for the whole stage
                                      # (1.0: each conv divides by its radius)
    pool_fc_dims: Optional[Tuple[int, ...]] = (8, 8, 16)
    pool_out: int = 32


@dataclass(frozen=True)
class PreStageSpec:
    """Semantic3D 'stage_pre': a conv on level 1 whose output is unpooled
    and concatenated onto the level-0 features
    (model_pointnet_semantic3d.py:119-127)."""

    radius: float
    k: int
    rescale: float
    fc_dims: Tuple[int, ...] = (16, 16, 16)
    out: int = 32


@dataclass(frozen=True)
class Arch:
    stages: Tuple[StageSpec, ...]
    global_dims: Tuple[int, ...] = (32, 32, 48)
    global_out: int = 128
    pre_stage: Optional[PreStageSpec] = None
    # ScanNet has no input features, hence no avg-pooled raw-feature cascade
    # (model_pointnet.py:1440 signature vs :930-933)
    use_avg_feats: bool = True
    # decoder: "concat" = unpool-concat (model_pointnet.py:1030-1036);
    # "deconv" = per-level growth-MLP refinement of [up ‖ stage ‖ dxyz]
    # (pointnet_deconv, model_pointnet.py:87-104, :620-636)
    decoder: str = "concat"
    deconv_dims: Tuple[Tuple[int, ...], ...] = ((128, 128), (64, 128))
    deconv_out: int = 256


# pointnet_13_dilated_embed (model_pointnet.py:930-1037), as in the JAX
# package's S3DIS_ARCH
S3DIS_ARCH = Arch(
    stages=(
        StageSpec(rescale=0.15, convs=(
            ConvSpec(radius=0.15, k=32, fc_dims=(8, 8, 16), out=32),
            ConvSpec(radius=0.2, min_radius=0.15, k=24,
                     fc_dims=(8, 8, 16), out=32),
            ConvSpec(radius=0.15, min_radius=0.1, k=16,
                     fc_dims=(8, 8, 16), out=32),
            ConvSpec(radius=0.1, k=16, embed=32, fc_dims=(8, 8, 16), out=32),
        ), pool_fc_dims=(8, 8, 16), pool_out=32),
        StageSpec(rescale=0.45, convs=(
            ConvSpec(radius=0.45, k=32, embed=64, fc_dims=(16, 16, 32),
                     out=64),
            ConvSpec(radius=0.6, min_radius=0.45, k=24, embed=48,
                     fc_dims=(16, 16, 16), out=48),
            ConvSpec(radius=0.6, min_radius=0.45, k=24, embed=48,
                     fc_dims=(16, 16, 16), out=48),
            ConvSpec(radius=0.45, min_radius=0.3, k=16, embed=64,
                     fc_dims=(16, 16, 16), out=48),
            ConvSpec(radius=0.45, min_radius=0.3, k=16, embed=64,
                     fc_dims=(16, 16, 16), out=48),
            ConvSpec(radius=0.3, k=16, embed=96, fc_dims=(16, 16, 16),
                     out=48),
            ConvSpec(radius=0.3, k=16, embed=96, fc_dims=(16, 16, 16),
                     out=48),
        ), pool_fc_dims=(16, 16, 16), pool_out=48),
        StageSpec(rescale=0.9, convs=(
            ConvSpec(radius=0.9, k=32, embed=128, fc_dims=(16, 16, 32),
                     out=64),
            ConvSpec(radius=0.9, k=32, embed=128, fc_dims=(16, 16, 32),
                     out=64),
        ), pool_fc_dims=None),
    ),
    global_dims=(32, 32, 48), global_out=128,
)


# pointnet_13_dilated_embed_scannet (model_pointnet.py:1440-1547), as in the
# JAX package's SCANNET_ARCH: the flagship's geometry, but the first conv is
# xyz-only (no input colors on ScanNet)
SCANNET_ARCH = Arch(
    stages=(
        StageSpec(rescale=0.15, convs=(
            ConvSpec(radius=0.15, k=32, fc_dims=(16, 16, 16), out=48,
                     nofeats=True),
        ) + S3DIS_ARCH.stages[0].convs[1:],
            pool_fc_dims=(8, 8, 16), pool_out=32),
    ) + S3DIS_ARCH.stages[1:],
    global_dims=(32, 32, 48), global_out=128,
    use_avg_feats=False,
)


# pointnet_10_concat_pre_embed_semantic3d
# (model_pointnet_semantic3d.py:114-213): 10 m blocks, larger radii, a
# level-1 pre-stage conv unpooled onto level 0, fc_embed before every conv.
SEMANTIC3D_ARCH = Arch(
    pre_stage=PreStageSpec(radius=0.6, k=16, rescale=0.6,
                           fc_dims=(16, 16, 16), out=32),
    stages=(
        StageSpec(rescale=1.0, convs=(
            # per-conv radii differ within the stage -> rescale encoded via
            # per-conv radius (sxyz /= radius): 0.3 then 0.2
            ConvSpec(radius=0.3, k=16, embed=16, fc_dims=(4, 4, 8), out=16),
            ConvSpec(radius=0.3, k=16, embed=16, fc_dims=(4, 4, 8), out=16),
            ConvSpec(radius=0.2, k=12, embed=32, fc_dims=(8, 8, 16), out=32),
            ConvSpec(radius=0.2, k=12, embed=32, fc_dims=(8, 8, 16), out=32),
        ), pool_fc_dims=(8, 8, 16), pool_out=24),
        StageSpec(rescale=1.0, convs=(
            ConvSpec(radius=0.6, k=16, embed=48, fc_dims=(8, 8, 16), out=32),
            ConvSpec(radius=0.6, k=16, embed=48, fc_dims=(8, 8, 16), out=32),
            ConvSpec(radius=0.4, k=12, embed=64, fc_dims=(16, 16, 24),
                     out=48),
            ConvSpec(radius=0.4, k=12, embed=96, fc_dims=(16, 16, 32),
                     out=64),
        ), pool_fc_dims=(16, 16, 16), pool_out=48),
        StageSpec(rescale=1.0, convs=(
            ConvSpec(radius=2.0, k=24, embed=128, fc_dims=(32, 32, 32),
                     out=96),
            ConvSpec(radius=2.0, k=24, embed=160, fc_dims=(32, 32, 64),
                     out=128),
        ), pool_fc_dims=None),
    ),
    global_dims=(32, 32, 64), global_out=128,
)


# pointnet_13_dilate_embed_semantic3d (model_pointnet_semantic3d.py:327-441):
# the dilated-annulus S3DIS recipe at Semantic3D scale — stage rescales
# 0.3/1.25/4.0 (every conv in a stage divides sxyz by the same constant),
# K caps from the reference's avg-count comments (22/20/16/18; 22; 14).
SEMANTIC3D_DILATE_ARCH = Arch(
    stages=(
        StageSpec(rescale=0.3, convs=(
            ConvSpec(radius=0.3, k=24, embed=32, fc_dims=(8, 8, 16), out=32),
            ConvSpec(radius=0.4, min_radius=0.3, k=20, embed=32,
                     fc_dims=(8, 8, 16), out=32),
            ConvSpec(radius=0.3, min_radius=0.2, k=16, embed=32,
                     fc_dims=(8, 8, 16), out=32),
            ConvSpec(radius=0.2, k=18, embed=32, fc_dims=(8, 8, 16), out=32),
        ), pool_fc_dims=(8, 8, 16), pool_out=32),
        StageSpec(rescale=1.25, convs=(
            ConvSpec(radius=1.25, k=22, embed=64, fc_dims=(16, 16, 32),
                     out=64),
            ConvSpec(radius=1.6, min_radius=1.25, k=22, embed=64,
                     fc_dims=(12, 12, 24), out=48),
            ConvSpec(radius=1.6, min_radius=1.25, k=22, embed=64,
                     fc_dims=(12, 12, 24), out=48),
            ConvSpec(radius=1.25, min_radius=0.9, k=22, embed=64,
                     fc_dims=(12, 12, 24), out=48),
            ConvSpec(radius=1.25, min_radius=0.9, k=22, embed=64,
                     fc_dims=(12, 12, 24), out=48),
            ConvSpec(radius=0.9, k=22, embed=64, fc_dims=(12, 12, 24),
                     out=48),
            ConvSpec(radius=0.9, k=22, embed=64, fc_dims=(12, 12, 24),
                     out=48),
        ), pool_fc_dims=(16, 16, 32), pool_out=64),
        StageSpec(rescale=4.0, convs=(
            ConvSpec(radius=4.0, k=14, embed=128, fc_dims=(32, 32, 32),
                     out=96),
            ConvSpec(radius=4.0, k=14, embed=160, fc_dims=(32, 32, 64),
                     out=128),
        ), pool_fc_dims=None),
    ),
    global_dims=(32, 32, 64), global_out=128,
)


# pointnet_20_baseline (model_pointnet.py:106-214): the no-growth ablation —
# 20 plain-MLP convs (pointnet_conv_noconcat), two radius tiers per stage,
# no annuli, no fc_embed.  K caps follow the flagship's per-radius choices.
def _nc(radius, k, fc_dims, out):
    return ConvSpec(radius=radius, k=k, fc_dims=fc_dims, out=out,
                    noconcat=True)


S3DIS_BASELINE20_ARCH = Arch(
    stages=(
        StageSpec(rescale=0.15, convs=(
            _nc(0.15, 32, (8, 8), 8), _nc(0.15, 32, (8, 8), 8),
            _nc(0.15, 32, (10, 12), 12), _nc(0.15, 32, (10, 12), 12),
            _nc(0.1, 16, (16, 16), 16), _nc(0.1, 16, (16, 16), 16),
            _nc(0.1, 16, (16, 16), 16), _nc(0.1, 16, (16, 16), 16),
        ), pool_fc_dims=(16, 16), pool_out=64),
        StageSpec(rescale=0.45, convs=(
            _nc(0.6, 32, (16, 16), 16), _nc(0.6, 32, (16, 16), 16),
            _nc(0.6, 32, (16, 16), 16), _nc(0.6, 32, (16, 16), 16),
            _nc(0.3, 16, (24, 24), 24), _nc(0.3, 16, (24, 24), 24),
            _nc(0.3, 16, (32, 32), 32), _nc(0.3, 16, (32, 32), 32),
        ), pool_fc_dims=(32, 32), pool_out=128),
        StageSpec(rescale=0.9, convs=(
            _nc(0.9, 32, (32, 32), 32), _nc(0.9, 32, (32, 32), 32),
            _nc(0.9, 32, (48, 48), 48), _nc(0.9, 32, (48, 48), 48),
        ), pool_fc_dims=None),
    ),
    global_dims=(64, 64, 128), global_out=256,
)


# pointnet_10_concat_pre_deconv (model_pointnet.py:563-637): the growth-conv
# 10-layer net (no embed, no annuli) with the DECONV decoder.
S3DIS_CONCAT10_DECONV_ARCH = Arch(
    stages=(
        StageSpec(rescale=0.15, convs=(
            ConvSpec(radius=0.15, k=32, fc_dims=(4, 4, 8), out=16),
            ConvSpec(radius=0.15, k=32, fc_dims=(4, 4, 8), out=16),
            ConvSpec(radius=0.1, k=16, fc_dims=(8, 8, 16), out=32),
            ConvSpec(radius=0.1, k=16, fc_dims=(8, 8, 16), out=32),
        ), pool_fc_dims=(16, 16), pool_out=64),
        StageSpec(rescale=0.45, convs=(
            ConvSpec(radius=0.6, k=32, fc_dims=(8, 8, 16), out=32),
            ConvSpec(radius=0.6, k=32, fc_dims=(8, 8, 16), out=32),
            ConvSpec(radius=0.3, k=16, fc_dims=(16, 16, 24), out=48),
            ConvSpec(radius=0.3, k=16, fc_dims=(16, 16, 32), out=64),
        ), pool_fc_dims=(32, 32), pool_out=128),
        StageSpec(rescale=0.9, convs=(
            ConvSpec(radius=0.9, k=32, fc_dims=(32, 32, 32), out=64),
            ConvSpec(radius=0.9, k=32, fc_dims=(32, 32, 48), out=96),
        ), pool_fc_dims=None),
    ),
    global_dims=(64, 64), global_out=256,
    decoder="deconv", deconv_dims=((128, 128), (64, 128)), deconv_out=256,
)


def no_dilation(arch: Arch) -> Arch:
    """Derive the embed-only ablation: the same net with every annulus
    collapsed to a plain radius search (pointnet_13_embed,
    model_pointnet.py:1236-1330, vs the dilated flagship :930-1037)."""
    stages = tuple(
        replace(st, convs=tuple(replace(c, min_radius=0.0)
                                for c in st.convs))
        for st in arch.stages)
    return replace(arch, stages=stages)


S3DIS_EMBED_ARCH = no_dilation(S3DIS_ARCH)


# settings of the JAX package's production build (train/model_zoo.py
# build_model), which it passes the encoder in place of the field defaults
OV_POOL_SIZE = 256   # tile-shared overflow pool (PCS_OV_POOL's default)
HEAD_DIM = 512       # factored head width (SegClassifier's first layer)


class PointNetSegEncoder(nn.Module):
    """Returns (head input, stage0 feats).  With ``head_dim`` (the factored
    head: every arch but the deconv one) the head input is the head's first
    Dense applied to the decoder concat, computed per source at its own
    level (head_dim wide); with None it is the wide decoder output
    (``out_width`` columns), which the head's ``class_mlp1`` maps.  The
    input features' width is ``feat_dim``; an arch whose first conv is
    xyz-only and that drops the avg-pooled cascade reads none of them, so
    any width will do there.

    The settings are the JAX encoder's fields, with its defaults
    (``models/pointnet.py:374-427``).  Levels that are Morton-sorted,
    tile-aligned and at least 4 tiles long take the windowed search (tile
    ``win_tile``, window ``win_window``, ``sel_mode`` selection over
    ``effective_win_cand_k(win_cand_k, cand_k, ...)`` candidates,
    ``ov_slots`` overflow slots per band); the others take the global
    search over ``min(cand_k, n)`` candidates.  The windowed search's
    overflow slots read through a tile-shared pool of ``ov_pool_size``
    rows (the JAX build passes 256, ``OV_POOL_SIZE``), or with 0 (the
    field default, which the JAX ``dense_semantic3d`` build keeps) hold
    per-point global indices.

    ``fast_conv=False`` builds the plain ``PointNetConv`` (the per-slot
    ``[center ‖ neighbor ‖ sxyz]`` MLP) for every concat conv in place of
    ``PointNetConvFast``; ``remat=True`` recomputes each concat conv's
    forward in the backward (``torch.utils.checkpoint``, as JAX applies
    ``nn.remat``) instead of keeping its activations.

    ``ov_mode="edges"`` (JAX ``models/pointnet.py:388-392``) replaces the
    overflow slots by one shared ``EdgeOverflow`` per windowed level, of
    ``edge_ratio`` x N rows (3 at stage 0, 5 deeper: deeper levels have
    more out-of-slab neighbors); every conv of the level, the pre-stage
    included, takes its band's rows of it.  ``ov_pool_size`` then plays
    no part."""

    def __init__(self, feat_dim: int, arch: Arch = S3DIS_ARCH,
                 search_chunk: int = 1024, cand_k: int = 64,
                 fast_conv: bool = True, windowed: bool = True,
                 win_tile: int = 256, win_window: int = 256,
                 ov_slots: int = 8, ov_mode: str = "slots",
                 ov_pool_size: int = 0, sel_mode: str = "slab",
                 win_cand_k: Optional[int] = 32,
                 head_dim: Optional[int] = None, remat: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if head_dim is not None and arch.decoder == "deconv":
            raise ValueError("the factored head needs the linear concat "
                             "decoder: use head_dim=None with deconv")
        if ov_mode not in ("slots", "edges"):
            raise ValueError(f"ov_mode must be slots or edges: {ov_mode}")
        self.ov_mode = ov_mode
        self.feat_dim = feat_dim
        self.arch = arch
        self.head_dim = head_dim
        self.search_chunk = search_chunk
        self.cand_k = cand_k
        self.win_cand_k = win_cand_k
        self.win_tile = win_tile
        self.win_window = win_window
        self.ov_slots = ov_slots
        self.ov_pool_size = ov_pool_size
        self.sel_mode = search.resolve_sel_mode(sel_mode)
        self.fast_conv = fast_conv
        self.remat = remat
        self.windowed = windowed
        self.dtype = dtype
        n_stages = len(arch.stages)
        w = feat_dim
        ps = arch.pre_stage
        if ps is not None:
            self.feats_pre = PointNetConv(feat_dim, ps.fc_dims, ps.out,
                                          dtype=dtype)
            w += ps.out
        conv_idx = embed_idx = 0
        stage_widths = []
        prev_w = w
        for s, stage in enumerate(arch.stages):
            for c in stage.convs:
                prev_w = w
                name = f"feats{conv_idx}"
                conv_idx += 1
                if c.nofeats:
                    # the output replaces the features (JAX :578-583)
                    self.add_module(name, PointNetConv(
                        0, c.fc_dims, c.out, use_feats=False, dtype=dtype))
                    w = c.out
                    continue
                fin = w
                if c.embed is not None:
                    self.add_module(f"embed{embed_idx}",
                                    FCEmbed(w, c.embed, dtype=dtype))
                    embed_idx += 1
                    fin = c.embed
                if c.noconcat:
                    conv = PointNetConv(fin, c.fc_dims, c.out,
                                        concat_growth=False, dtype=dtype)
                else:
                    conv_cls = PointNetConvFast if fast_conv else PointNetConv
                    conv = conv_cls(fin, c.fc_dims, c.out, dtype=dtype)
                self.add_module(name, conv)
                w += c.out
            stage_widths.append(w)
            if s < n_stages - 1:
                pw = (feat_dim if arch.use_avg_feats else 0) + w
                if stage.pool_fc_dims is not None:
                    self.add_module(f"pool{s}", PointNetPoolMLP(
                        w, stage.pool_fc_dims, stage.pool_out, dtype=dtype))
                    pw += stage.pool_out
                w = pw
        top = n_stages - 1
        self.add_module("global", GrowthMLP(3 + prev_w, arch.global_dims,
                                            arch.global_out, dtype=dtype))
        self.stage0_width = stage_widths[0]
        if head_dim is not None:
            self.add_module(f"head_sf{top}", Dense(
                stage_widths[top], head_dim, bias=False, dtype=dtype))
            self.head_g = Dense(arch.global_out, head_dim, bias=False,
                                dtype=dtype)
            for s in range(top - 1, -1, -1):
                self.add_module(f"head_sf{s}", Dense(
                    stage_widths[s], head_dim, bias=(s == 0), dtype=dtype))
            self.out_width = head_dim
            return
        lw = stage_widths[top] + arch.global_out
        for s in range(top - 1, -1, -1):
            if arch.decoder == "deconv":
                dd = arch.deconv_dims[min(s, len(arch.deconv_dims) - 1)]
                self.add_module(f"deconv{s}", GrowthMLP(
                    lw + stage_widths[s] + 3, dd, arch.deconv_out,
                    new_first=False, dtype=dtype))
                lw += arch.deconv_out
            lw += stage_widths[s]
        self.out_width = lw

    def _stage_neighborhoods(self, xyz: torch.Tensor, mask: torch.Tensor,
                             specs, is_sorted: bool,
                             edge_ratio: int = 3) -> Dict:
        """All of a stage's (radius, min_radius, k) searches in one pass;
        returns spec -> (neighborhood, sxyz, edges): the level's shared
        ``EdgeOverflow`` where ``ov_mode="edges"`` and the level is
        windowed, else None."""
        with profiling.span("pcs.search"):
            uniq = list(dict.fromkeys(specs))
            bands = tuple((mn, mx, k) for (mx, mn, k) in uniq)
            n = xyz.shape[0]
            chunk = min(self.search_chunk, n)
            if (self.windowed and is_sorted and n % self.win_tile == 0
                    and n >= 4 * self.win_tile):
                # no wide overflow tier: the JAX encoder passes ov_window=0
                res = search.windowed_multi_band_neighbors(
                    xyz, mask, bands, tile=self.win_tile,
                    window=self.win_window,
                    cand_k=search.effective_win_cand_k(
                        self.win_cand_k, self.cand_k, bands, n),
                    ov_slots=self.ov_slots, chunk=chunk,
                    ov_pool_size=self.ov_pool_size, return_sxyz=True,
                    ov_mode=self.ov_mode, edge_ratio=edge_ratio,
                    sel_mode=self.sel_mode)
                if self.ov_mode == "edges":
                    return dict(zip(uniq, res))
            else:
                res = search.multi_band_neighbors(
                    xyz, mask, bands, cand_k=min(self.cand_k, n),
                    chunk=chunk, return_sxyz=True)
            return {spec: (nbr, sx, None)
                    for spec, (nbr, sx) in zip(uniq, res)}

    def stage_specs(self, s: int):
        """The (radius, min_radius, k) of every search at stage ``s``: its
        convs' bands, and at stage 1 the pre-stage's (JAX :528-530)."""
        specs = [(c.radius, c.min_radius, c.k)
                 for c in self.arch.stages[s].convs]
        ps = self.arch.pre_stage
        if s == 1 and ps is not None:
            specs.append((ps.radius, 0.0, ps.k))
        return specs

    def forward(self, pyramid: Pyramid, feats: torch.Tensor):
        arch = self.arch
        n_stages = len(arch.stages)
        if pyramid.num_levels < n_stages:
            raise ValueError(f"pyramid has {pyramid.num_levels} levels, "
                             f"the arch needs {n_stages}")
        avg_feats = [feats]
        if arch.use_avg_feats:
            for lvl in range(n_stages - 1):
                avg_feats.append(hier.pool_avg(avg_feats[-1], pyramid, lvl))

        caches, edge_caches = [], []
        for s in range(n_stages):
            nbrs = self._stage_neighborhoods(
                pyramid.levels[s].xyz, pyramid.levels[s].mask,
                self.stage_specs(s), pyramid.level_sorted(s),
                edge_ratio=3 if s == 0 else 5)
            caches.append({sp: (nb, sx if self.dtype is None
                                else sx.to(self.dtype))
                           for sp, (nb, sx, _) in nbrs.items()})
            edge_caches.append(next(iter(nbrs.values()))[2])

        # Semantic3D's pre-stage: a conv on level 1's avg-pooled raw
        # features, unpooled and prepended to level 0's (JAX :542-553)
        ps = arch.pre_stage
        if ps is not None:
            nbr, sxyz = caches[1][(ps.radius, 0.0, ps.k)]
            pre = self.feats_pre(sxyz / ps.rescale, avg_feats[1], nbr,
                                 edges=edge_caches[1],
                                 edge_band=(0.0, ps.radius),
                                 edge_rescale=ps.rescale)
            feats = torch.cat([hier.unpool(pre, pyramid, 0), feats], dim=-1)

        stage_feats = []
        conv_idx = embed_idx = 0
        prev_feats = feats
        for s, stage in enumerate(arch.stages):
            for c in stage.convs:
                prev_feats = feats
                nbr, sxyz_raw = caches[s][(c.radius, c.min_radius, c.k)]
                # a stage rescale of 1.0 means: divide by each conv's own
                # radius (JAX models/pointnet.py:575)
                rescale = stage.rescale if stage.rescale != 1.0 else c.radius
                sxyz = sxyz_raw / rescale
                conv = getattr(self, f"feats{conv_idx}")
                conv_idx += 1
                ekw = dict(edges=edge_caches[s],
                           edge_band=(c.min_radius, c.radius),
                           edge_rescale=rescale)
                if c.nofeats:
                    feats = conv(sxyz, None, nbr, **ekw)
                    continue
                fin = feats
                if c.embed is not None:
                    fin = getattr(self, f"embed{embed_idx}")(feats)
                    embed_idx += 1
                if self.remat and not c.noconcat:
                    out = checkpoint(conv, sxyz, fin, nbr, use_reentrant=False,
                                     **ekw)
                else:
                    out = conv(sxyz, fin, nbr, **ekw)
                feats = torch.cat([feats, out], dim=-1)
            stage_feats.append(feats)
            if s < n_stages - 1:
                parts = [avg_feats[s + 1]] if arch.use_avg_feats else []
                parts.append(hier.pool_max(feats, pyramid, s))
                if stage.pool_fc_dims is not None:
                    pf = getattr(self, f"pool{s}")(pyramid.dxyz[s], feats)
                    parts.append(hier.pool_max(pf, pyramid, s))
                feats = torch.cat(parts, dim=-1)

        # the global MLP sees the features before the top stage's last
        # concat (model_pointnet.py:1025-1028)
        top = n_stages - 1
        gin = torch.cat([pyramid.levels[top].xyz, prev_feats], dim=-1)
        gfc = getattr(self, "global")(gin)
        if self.head_dim is not None:
            z = getattr(self, f"head_sf{top}")(stage_feats[top]) \
                + self.head_g(gfc)
            for s in range(top - 1, -1, -1):
                z = hier.unpool(z, pyramid, s) \
                    + getattr(self, f"head_sf{s}")(stage_feats[s])
            return z, stage_feats[0]

        # the unfactored decoders (JAX :650-665): unpool-concat, or the
        # deconv's growth MLP on [up ‖ stage feats ‖ dxyz] at each level
        lf = torch.cat([stage_feats[top], gfc], dim=-1)
        for s in range(top - 1, -1, -1):
            up = hier.unpool(lf, pyramid, s)
            if arch.decoder == "deconv":
                din = torch.cat([up, stage_feats[s], pyramid.dxyz[s]],
                                dim=-1)
                upf = getattr(self, f"deconv{s}")(din)
                lf = torch.cat([upf, up, stage_feats[s]], dim=-1)
            else:
                lf = torch.cat([up, stage_feats[s]], dim=-1)
        return lf, stage_feats[0]


class PointNet2Baseline(nn.Module):
    """pointnet2_v2 (JAX ``models/pointnet.py:293-365``): the
    PointNet++-style baseline.  Per unit a narrow pointnet conv (``pn{i}``)
    feeds a second, wider one (``pn{i}b``), or at stage 2 an
    ``MLPAnchorConv`` (``anchor{i}``), and both outputs join the growth
    concat; one multi-band search per stage (per-point overflow slots); a
    pointnet pool (``pool{s}``) between stages; the growth MLP ``global``
    on [top xyz ‖ top feats]; unpool-concat decoder.  Returns (decoder
    output, stage-0 feats) for the unfactored head."""

    head_dim = None
    cand_k = 64
    # (radius, k, fc_a, out_a, fc_b, out_b) per unit; stage 2 units use
    # (radius, k, fc_a, out_a, anchor_weights, anchor_out, anchor_num)
    STAGE0 = ((0.15, 32, (8,), 8, (8, 16), 16),
              (0.15, 32, (8,), 8, (8, 16), 16),
              (0.1, 16, (16,), 16, (16, 32), 32),
              (0.1, 16, (16,), 16, (16, 32), 32))
    STAGE1 = ((0.6, 32, (16,), 16, (16, 32), 32),
              (0.6, 32, (16,), 16, (16, 32), 32),
              (0.3, 16, (16,), 16, (24, 48), 48),
              (0.3, 16, (20,), 20, (32, 64), 64))
    STAGE2 = ((0.9, 32, (24,), 24, (32,), 64, 12),
              (0.9, 32, (24,), 24, (48,), 96, 16))
    STAGES = (STAGE0, STAGE1, STAGE2)
    POOLS = (((16, 16), 64), ((32, 32), 128))

    def __init__(self, feat_dim: int, search_chunk: int = 1024,
                 dtype: Optional[torch.dtype] = None, windowed: bool = True):
        super().__init__()
        self.search_chunk = search_chunk
        self.windowed = windowed
        self.dtype = dtype
        w = feat_dim
        ci = 0
        stage_widths = []
        for s, units in enumerate(self.STAGES):
            for u in units:
                self.add_module(f"pn{ci}", PointNetConv(w, u[2], u[3],
                                                        dtype=dtype))
                if len(u) == 7:
                    self.add_module(f"anchor{ci}", MLPAnchorConv(
                        u[3], u[4], u[5], u[6], dtype=dtype))
                else:
                    self.add_module(f"pn{ci}b", PointNetConv(
                        u[3], u[4], u[5], dtype=dtype))
                w += u[5] + u[3]
                ci += 1
            stage_widths.append(w)
            if s < 2:
                dims, out = self.POOLS[s]
                self.add_module(f"pool{s}", PointNetPoolMLP(w, dims, out,
                                                            dtype=dtype))
                w = out
        self.add_module("global", GrowthMLP(3 + w, (64, 64, 128), 256,
                                            dtype=dtype))
        self.out_width = 256 + sum(stage_widths)
        self.stage0_width = stage_widths[0]

    def forward(self, pyramid: Pyramid, feats: torch.Tensor):
        stage_feats = []
        ci = 0
        for s, units in enumerate(self.STAGES):
            lvl = pyramid.levels[s]
            n = lvl.xyz.shape[0]
            uniq = list(dict.fromkeys((u[0], u[1]) for u in units))
            res = search.band_neighbors_auto(
                lvl.xyz, lvl.mask, tuple((0.0, r, k) for r, k in uniq),
                cand_k=min(self.cand_k, n),
                chunk=min(self.search_chunk, n), return_sxyz=True,
                sorted=pyramid.level_sorted(s), windowed=self.windowed)
            nbrs = dict(zip(uniq, res))
            for u in units:
                nbr, sxyz_raw = nbrs[(u[0], u[1])]
                sxyz = sxyz_raw / u[0]
                pn = getattr(self, f"pn{ci}")(sxyz, feats, nbr)
                second = getattr(self, f"anchor{ci}" if len(u) == 7
                                 else f"pn{ci}b")(sxyz, pn, nbr)
                feats = torch.cat([feats, second, pn], dim=-1)
                ci += 1
            stage_feats.append(feats)
            if s < 2:
                pooled = getattr(self, f"pool{s}")(pyramid.dxyz[s], feats)
                feats = hier.pool_max(pooled, pyramid, s)
        gin = torch.cat([pyramid.levels[2].xyz, feats], dim=-1)
        lf = torch.cat([getattr(self, "global")(gin), stage_feats[2]],
                       dim=-1)
        for s in (1, 0):
            lf = torch.cat([hier.unpool(lf, pyramid, s), stage_feats[s]],
                           dim=-1)
        return lf, stage_feats[0]
