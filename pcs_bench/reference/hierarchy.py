"""Voxel pooling hierarchy: a frozen copy of the port's ``ops/hierarchy.py``
(points stay in place; each level maps its points into the next)."""
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


def build_class_pyramid(xyz: torch.Tensor, mask: torch.Tensor,
                        labels: torch.Tensor, voxel_size: float, cap: int,
                        block_size: float = 3.0,
                        morton_sorted: bool = False) -> Pyramid:
    """Two levels whose voxels are class-pure (JAX ``ops/hierarchy.py:
    80-103``, the refine cascade's hierarchy): the points, then the centers
    of their (voxel, label) segments.  Points stay in place."""
    info = vox.voxelize_with_labels(xyz, mask, labels, voxel_size,
                                    block_size, cap)
    dxyz = vox.diff_to_center(xyz, info.centers, info.seg)
    dxyz = torch.where(mask[:, None], dxyz, torch.zeros_like(dxyz))
    return Pyramid(levels=(Level(xyz=xyz, mask=mask),
                           Level(xyz=info.centers, mask=info.mask)),
                   seg=(info.seg,), dxyz=(dxyz,),
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


def average_downsample(xyz: torch.Tensor, feats: torch.Tensor,
                       mask: torch.Tensor, ds_size: float,
                       block_size: float, v_max: int):
    """Voxel-mean downsample of coordinates and features
    (``average_downsample``; JAX ``ops/hierarchy.py:106-121``): voxels of
    ``ds_size``, at most ``v_max``.  Returns (center_xyz [v_max, 3],
    center_feats [v_max, F], the mean of the valid member points' features
    and 0 for an empty voxel, vmask [v_max])."""
    info = vox.voxelize(xyz, mask, ds_size, block_size, v_max)
    mf = mask[:, None].to(feats.dtype)
    cf = seg_ops.segment_mean(feats * mf, info.seg, v_max)
    return info.centers, cf, info.mask
