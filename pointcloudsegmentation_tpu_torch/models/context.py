"""The context branch of Semantic3D (mirror of
``pointcloudsegmentation_tpu.models.context``).

Each 10 m block comes with a 50 m context cloud averaged over 5 m voxels
(``data.semantic3d.prepare_context_scene``) and, per block point, the
index of its nearest context point.  ``ContextNet`` runs two ECD stages on
the context cloud's own one-level pyramid; each block point gathers its
context point's features, which join the main branch's global features
before the classifier (model_pooling.py:393-427,
semantic3d_context_util.py:322-333, train_gpn_semantic3d_context.py:
50-71).  The block's Morton sort carries the context indices with the
points, so the logits do not depend on the order of the block's points."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops import hierarchy as hier
from ..ops import morton
from ..ops.types import Pyramid
from .ecd import (ECDStage, ECDStageSpec, _masked_global_max,
                  _masked_global_mean)
from .layers import SegClassifier

# the context cloud's features: rgb and standardised intensity
# (data/semantic3d.py:prepare_context_scene)
CTX_FEAT_DIM = 4
# the context cloud's static capacity: the Provider pads each block's
# cloud to it and ContextFusionModel caps the cloud's voxels at it
CTX_CAP = 512


class ContextNet(nn.Module):
    """``graph_conv_pool_context_with_pool`` (JAX ``models/context.py:
    35-67``): an ECD stage on the context points, a voxel pool (max of
    its fc ‖ mean of its features), an ECD stage on the voxel centers with
    their raw xyz as dxyz, the global max/mean tiled back, then the
    unpool-concat.  Both stages take the global search: the JAX stages are
    called without the sorted flag, and the context cloud is not
    Morton-sorted.  Returns [n_ctx, ``out_width``]."""

    STAGE0 = ECDStageSpec(radius=5.0, k=16, gxyz_dim=16, gc_dims=(16, 16, 16),
                          gfc_dims=(16, 16, 16), final_dim=64,
                          dxyz_scale=5.0)
    STAGE1 = ECDStageSpec(radius=15.0, k=16, gxyz_dim=16,
                          gc_dims=(32, 32, 32), gfc_dims=(32, 32, 64),
                          final_dim=256, dxyz_scale=50.0)

    SEARCH_CHUNK = 512

    def __init__(self, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.stage0 = ECDStage(self.STAGE0, CTX_FEAT_DIM, dtype=dtype)
        w0 = self.STAGE0.final_dim + self.stage0.lf_width
        self.stage1 = ECDStage(self.STAGE1, w0, dtype=dtype)
        w1 = self.STAGE1.final_dim + self.stage1.lf_width
        self.out_width = 2 * w1 + w0

    def forward(self, pyramid: Pyramid, feats: torch.Tensor) -> torch.Tensor:
        lvl0, lvl1 = pyramid.levels[0], pyramid.levels[1]
        fc0, lf0 = self.stage0(lvl0.xyz, lvl0.mask, pyramid.dxyz[0], feats,
                               chunk=self.SEARCH_CHUNK)
        pooled = torch.cat([hier.pool_max(fc0, pyramid, 0),
                            hier.pool_avg(lf0, pyramid, 0)], dim=-1)
        fc1, lf1 = self.stage1(lvl1.xyz, lvl1.mask, lvl1.xyz, pooled,
                               chunk=self.SEARCH_CHUNK)
        gvec = torch.cat([_masked_global_max(fc1, lvl1.mask),
                          _masked_global_mean(lf1, lvl1.mask)], dim=0)
        up1 = torch.cat([gvec[None, :].expand(fc1.shape[0], -1), fc1, lf1],
                        dim=-1)
        return torch.cat([hier.unpool(up1, pyramid, 0), fc0, lf0], dim=-1)


class ContextFusionModel(nn.Module):
    """The two-resolution fusion (JAX ``models/context.py:70-131``): the
    main branch ``encoder`` on the Morton-sorted block (the sort carries
    ``ctx_idx``), ``ContextNet`` (``context``) on the context cloud's
    unsorted pyramid of ``ctx_voxel_size`` voxels capped at ``ctx_cap``
    over a ``ctx_block_size`` block (the JAX defaults: a 50 m window at 5 m
    voxels holds up to ~11*11*z cells); each block point takes its context
    point's row (index clipped into the cloud, zero for a padded point),
    concatenated after the main global features, into the unfactored
    ``head``; logits in the caller's point order.  ``extra_keys`` name the
    batch fields the forward takes after (xyz, feats, mask)."""

    extra_keys = ("ctx_xyz", "ctx_feats", "ctx_mask", "ctx_idx")
    ctx_voxel_size, ctx_cap, ctx_block_size = 5.0, CTX_CAP, 50.0

    def __init__(self, encoder: nn.Module, num_classes: int,
                 voxel_sizes: Tuple[float, ...] = (0.25, 1.0),
                 caps: Tuple[int, ...] = (5120, 1280),
                 block_size: float = 10.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.encoder = encoder
        self.context = ContextNet(dtype=dtype)
        self.head = SegClassifier(
            num_classes, encoder.out_width + self.context.out_width,
            encoder.stage0_width, premixed=False, dtype=dtype)
        self.voxel_sizes = tuple(voxel_sizes)
        self.caps = tuple(caps)
        self.block_size = block_size

    def forward(self, xyz: torch.Tensor, feats: torch.Tensor,
                mask: torch.Tensor, ctx_xyz: torch.Tensor,
                ctx_feats: torch.Tensor, ctx_mask: torch.Tensor,
                ctx_idx: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """xyz [N, 3], feats [N, F], mask [N], ctx_xyz [M, 3], ctx_feats
        [M, Fc], ctx_mask [M], ctx_idx [N] -> logits [N, C]."""
        cell = self.voxel_sizes[0] / 4.0
        xyz, mask, order, feats, ctx_idx = morton.sort_block(
            xyz, mask, cell, self.block_size, feats, ctx_idx)
        pyr = hier.build_pyramid(xyz, mask, self.voxel_sizes, self.caps,
                                 self.block_size, morton_sorted=True)
        gf, lf = self.encoder(pyr, feats)
        ctx_pyr = hier.build_pyramid(ctx_xyz, ctx_mask,
                                     (self.ctx_voxel_size,), (self.ctx_cap,),
                                     self.ctx_block_size)
        ctx_up = self.context(ctx_pyr, ctx_feats)
        per_point = ctx_up[ctx_idx.long().clamp(0, ctx_up.shape[0] - 1)]
        per_point = per_point * mask[:, None].to(per_point.dtype)
        logits = self.head(torch.cat([gf, per_point], dim=-1), lf, train,
                           generator)
        return logits[morton.inverse_permutation(order)]
