"""Voxel pooling hierarchy (mirror of
``pointcloudsegmentation_tpu.ops.hierarchy``): points stay in place and each
level carries a segment-id map into the next."""
from __future__ import annotations

from typing import Sequence

import torch

from . import segments as seg_ops
from . import voxelize as vox
from .types import Level, Pyramid


def build_pyramid(xyz: torch.Tensor, mask: torch.Tensor,
                  voxel_sizes: Sequence[float], caps: Sequence[int],
                  block_size: float = 3.0,
                  morton_sorted: bool = False) -> Pyramid:
    """Level 0 is the input; level i+1 holds the voxel centers of level i
    voxelized at voxel_sizes[i] with static capacity caps[i]."""
    levels = [Level(xyz=xyz, mask=mask)]
    segs, dxyzs = (), ()
    cur_xyz, cur_mask = xyz, mask
    for vs, cap in zip(voxel_sizes, caps):
        info = vox.voxelize(cur_xyz, cur_mask, vs, block_size, cap)
        dxyz = vox.diff_to_center(cur_xyz, info.centers, info.seg)
        dxyz = torch.where(cur_mask[:, None], dxyz, torch.zeros_like(dxyz))
        segs += (info.seg,)
        dxyzs += (dxyz,)
        cur_xyz, cur_mask = info.centers, info.mask
        levels.append(Level(xyz=cur_xyz, mask=cur_mask))
    return Pyramid(levels=tuple(levels), seg=segs, dxyz=dxyzs,
                   morton_sorted=morton_sorted)


def pool_max(feats: torch.Tensor, pyramid: Pyramid,
             level: int) -> torch.Tensor:
    """Voxel max-pool level -> level+1."""
    cap = pyramid.levels[level + 1].xyz.shape[0]
    return seg_ops.segment_max(feats, pyramid.seg[level], cap)


def pool_avg(feats: torch.Tensor, pyramid: Pyramid,
             level: int) -> torch.Tensor:
    """Voxel average-pool level -> level+1 over valid points."""
    cap = pyramid.levels[level + 1].xyz.shape[0]
    m = pyramid.levels[level].mask[:, None].to(feats.dtype)
    return seg_ops.segment_mean(feats * m, pyramid.seg[level], cap)


def unpool(feats: torch.Tensor, pyramid: Pyramid, level: int) -> torch.Tensor:
    """Broadcast level+1 voxel features to level points."""
    return seg_ops.segment_unpool(feats, pyramid.seg[level])
