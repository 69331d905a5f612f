"""Sort-based voxelization with static capacity (mirror of
``pointcloudsegmentation_tpu.ops.voxelize``).  Points keep their order; each
gets a voxel slot id, and voxels beyond ``v_max`` (and invalid points) map
to the overflow slot ``v_max``."""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import segments as seg_ops
from .morton import _INT32_MAX, masked_min_corner, morton_code


class VoxelInfo(NamedTuple):
    """seg [N] int32 in [0, v_max]; centers [v_max, 3]; counts [v_max];
    mask [v_max] (voxel occupied)."""

    seg: torch.Tensor
    centers: torch.Tensor
    counts: torch.Tensor
    mask: torch.Tensor


def voxel_coords(xyz: torch.Tensor, voxel_size: float, block_size: float,
                 mask: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Integer voxel coordinates on a lattice anchored at the masked min
    corner quantized to multiples of ``voxel_size``; ``block_size`` only
    sizes the grid, capped at the 10-bit Morton key space."""
    grid = min(int(-(-block_size // voxel_size)) + 2, 1 << 10)
    lo = masked_min_corner(xyz, mask)
    lo = voxel_size * torch.floor(lo / voxel_size)
    c = torch.floor((xyz - lo[None, :]) / voxel_size).to(torch.int32)
    return c.clamp(0, grid - 1), grid


def pack_keys(coords: torch.Tensor, grid: int) -> torch.Tensor:
    """Morton keys, so coarser levels come out Morton-sorted."""
    if grid > 1024:
        raise ValueError(f"grid {grid} exceeds the 10-bit key space")
    return morton_code(coords)


def compute_segments(key: torch.Tensor, mask: torch.Tensor,
                     v_max: int) -> torch.Tensor:
    """Dense voxel slot per point via stable sort + unique-rank scan;
    invalid points and voxels past ``v_max`` map to ``v_max``."""
    key = torch.where(mask, key, torch.full_like(key, _INT32_MAX))
    order = torch.sort(key, stable=True).indices
    skey = key[order]
    is_new = torch.ones_like(skey, dtype=torch.bool)
    is_new[1:] = skey[1:] != skey[:-1]
    rank = torch.cumsum(is_new.to(torch.int32), 0, dtype=torch.int32) - 1
    keep = mask[order] & (rank < v_max)
    rank = torch.where(keep, rank, torch.full_like(rank, v_max))
    seg = torch.empty_like(rank)
    seg[order] = rank
    return seg


def voxelize(xyz: torch.Tensor, mask: torch.Tensor, voxel_size: float,
             block_size: float, v_max: int) -> VoxelInfo:
    """coords -> keys -> segments -> centers (mean xyz per voxel)."""
    coords, grid = voxel_coords(xyz, voxel_size, block_size, mask)
    seg = compute_segments(pack_keys(coords, grid), mask, v_max)
    counts = seg_ops.segment_count(seg, v_max)
    centers = seg_ops.segment_sum(xyz * mask[:, None].to(xyz.dtype), seg,
                                  v_max)
    centers = centers / counts[:, None].clamp(min=1.0)
    return VoxelInfo(seg=seg, centers=centers, counts=counts,
                     mask=counts > 0)


def diff_to_center(xyz: torch.Tensor, centers: torch.Tensor,
                   seg: torch.Tensor) -> torch.Tensor:
    """Per-point offset from its voxel center (overflow points: xyz - 0)."""
    return xyz - seg_ops.segment_unpool(centers, seg)
