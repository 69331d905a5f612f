"""PointNet-conv segmentation encoder (mirror of
``pointcloudsegmentation_tpu.models.pointnet`` for the flagship and its
ScanNet variant: the concat decoder with the factored head, fast convs fed
by the search's sxyz, the xyz-only first conv).

Per stage (= pyramid level): one shared multi-band search, then each conv
(optional fc_embed bottleneck -> PointNetConvFast -> concat growth, or an
xyz-only PointNetConv whose output replaces the features); between stages a
voxel pool block; a global growth MLP at the top; the factored head
projects each stage at its own level and unpools head_dim-wide sums."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..ops import hierarchy as hier
from ..ops import search
from ..ops.types import Pyramid
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


@dataclass(frozen=True)
class StageSpec:
    convs: Tuple[ConvSpec, ...]
    rescale: float                    # sxyz divisor for the whole stage
                                      # (1.0: each conv divides by its radius)
    pool_fc_dims: Optional[Tuple[int, ...]] = (8, 8, 16)
    pool_out: int = 32


@dataclass(frozen=True)
class Arch:
    stages: Tuple[StageSpec, ...]
    global_dims: Tuple[int, ...] = (32, 32, 48)
    global_out: int = 128
    # ScanNet has no input features, hence no avg-pooled raw-feature cascade
    # (model_pointnet.py:1440 signature vs :930-933)
    use_avg_feats: bool = True


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


# search settings of the JAX package's production build (train/model_zoo.py
# build_model and PointNetSegEncoder defaults)
CAND_K = 64          # global search candidates
WIN_CAND_K = 32      # windowed slab candidates
OV_SLOTS = 8         # overflow slots per band
OV_POOL_SIZE = 256   # tile-shared overflow pool
HEAD_DIM = 512       # factored head width (SegClassifier's first layer)


class PointNetSegEncoder(nn.Module):
    """Returns (z, stage0 feats): z is the head's first Dense applied to the
    decoder concat, computed per source at its own level (HEAD_DIM wide).
    The input features' width is ``feat_dim``; an arch whose first conv is
    xyz-only and that drops the avg-pooled cascade reads none of them, so
    any width will do there.

    Levels that are Morton-sorted, tile-aligned and at least 4 tiles long
    take the windowed search (tile/window 256 by default); the others take
    the global search."""

    def __init__(self, feat_dim: int, arch: Arch = S3DIS_ARCH,
                 search_chunk: int = 1024, win_tile: int = 256,
                 win_window: int = 256, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.arch = arch
        self.search_chunk = search_chunk
        self.win_tile = win_tile
        self.win_window = win_window
        self.dtype = dtype
        n_stages = len(arch.stages)
        w = feat_dim
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
                    self.add_module(name, PointNetConv(c.fc_dims, c.out,
                                                       dtype=dtype))
                    w = c.out
                    continue
                fin = w
                if c.embed is not None:
                    self.add_module(f"embed{embed_idx}",
                                    FCEmbed(w, c.embed, dtype=dtype))
                    embed_idx += 1
                    fin = c.embed
                self.add_module(name, PointNetConvFast(fin, c.fc_dims, c.out,
                                                       dtype=dtype))
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
        self.add_module(f"head_sf{top}", Dense(stage_widths[top], HEAD_DIM,
                                               bias=False, dtype=dtype))
        self.head_g = Dense(arch.global_out, HEAD_DIM, bias=False, dtype=dtype)
        for s in range(top - 1, -1, -1):
            self.add_module(f"head_sf{s}", Dense(stage_widths[s], HEAD_DIM,
                                                 bias=(s == 0), dtype=dtype))
        self.stage0_width = stage_widths[0]

    def _stage_neighborhoods(self, xyz: torch.Tensor, mask: torch.Tensor,
                             specs, is_sorted: bool) -> Dict:
        """All of a stage's (radius, min_radius, k) searches in one pass;
        returns spec -> (neighborhood, sxyz)."""
        uniq = list(dict.fromkeys(specs))
        bands = tuple((mn, mx, k) for (mx, mn, k) in uniq)
        n = xyz.shape[0]
        chunk = min(self.search_chunk, n)
        if is_sorted and n % self.win_tile == 0 and n >= 4 * self.win_tile:
            res = search.windowed_multi_band_neighbors(
                xyz, mask, bands, tile=self.win_tile, window=self.win_window,
                cand_k=search.effective_win_cand_k(WIN_CAND_K, CAND_K,
                                                   bands, n),
                ov_slots=OV_SLOTS, chunk=chunk, ov_pool_size=OV_POOL_SIZE,
                return_sxyz=True)
        else:
            res = search.multi_band_neighbors(
                xyz, mask, bands, cand_k=min(CAND_K, n), chunk=chunk,
                return_sxyz=True)
        return dict(zip(uniq, res))

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

        caches = []
        for s, stage in enumerate(arch.stages):
            specs = [(c.radius, c.min_radius, c.k) for c in stage.convs]
            nbrs = self._stage_neighborhoods(
                pyramid.levels[s].xyz, pyramid.levels[s].mask, specs,
                pyramid.level_sorted(s))
            if self.dtype is not None:
                nbrs = {sp: (nb, sx.to(self.dtype))
                        for sp, (nb, sx) in nbrs.items()}
            caches.append(nbrs)

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
                if c.nofeats:
                    feats = conv(sxyz, nbr.mask)
                    continue
                fin = feats
                if c.embed is not None:
                    fin = getattr(self, f"embed{embed_idx}")(feats)
                    embed_idx += 1
                feats = torch.cat([feats, conv(sxyz, fin, nbr)], dim=-1)
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
        z = getattr(self, f"head_sf{top}")(stage_feats[top]) + self.head_g(gfc)
        for s in range(top - 1, -1, -1):
            z = hier.unpool(z, pyramid, s) \
                + getattr(self, f"head_sf{s}")(stage_feats[s])
        return z, stage_feats[0]
