"""Voxel segments of a block: a frozen copy of the port's
``ops/voxelize.py``."""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

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
                 mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, int]:
    """Integer voxel coordinates on a lattice anchored at the (masked,
    with ``mask``) min corner quantized to multiples of ``voxel_size``;
    ``block_size`` only sizes the grid, capped at the 10-bit Morton key
    space."""
    grid = min(int(-(-block_size // voxel_size)) + 2, 1 << 10)
    lo = xyz.amin(dim=0) if mask is None else masked_min_corner(xyz, mask)
    lo = voxel_size * torch.floor(lo / voxel_size)
    c = torch.floor((xyz - lo[None, :]) / voxel_size).to(torch.int32)
    return c.clamp(0, grid - 1), grid


def pack_keys(coords: torch.Tensor, grid: int) -> torch.Tensor:
    """Morton keys, so coarser levels come out Morton-sorted."""
    if grid > 1024:
        raise ValueError(f"grid {grid} exceeds the 10-bit key space")
    return morton_code(coords)


def compute_segments(key: torch.Tensor, mask: torch.Tensor, v_max: int,
                     key2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense voxel slot per point via stable sort + unique-rank scan;
    invalid points and voxels past ``v_max`` map to ``v_max``.  With
    ``key2`` (e.g. class labels) a segment is one distinct (key, key2)
    pair, ``key`` primary: the JAX ``lexsort((key2, key))`` as one stable
    sort of the int64 ``key * 2^32 + (key2 + 2^31)``, which orders the
    pairs the same way, so the segments stay in voxel-key order."""
    key = torch.where(mask, key, torch.full_like(key, _INT32_MAX)).long()
    if key2 is not None:
        key2 = torch.where(mask, key2.to(torch.int32),
                           torch.zeros_like(key2, dtype=torch.int32))
        key = key * (1 << 32) + (key2.long() + (1 << 31))
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


def _voxel_info(xyz: torch.Tensor, mask: torch.Tensor, seg: torch.Tensor,
                v_max: int) -> VoxelInfo:
    counts = seg_ops.segment_count(seg, v_max)
    centers = seg_ops.segment_sum(xyz * mask[:, None].to(xyz.dtype), seg,
                                  v_max)
    centers = centers / counts[:, None].clamp(min=1.0)
    return VoxelInfo(seg=seg, centers=centers, counts=counts,
                     mask=counts > 0)


def voxelize(xyz: torch.Tensor, mask: torch.Tensor, voxel_size: float,
             block_size: float, v_max: int) -> VoxelInfo:
    """coords -> keys -> segments -> centers (mean xyz per voxel)."""
    coords, grid = voxel_coords(xyz, voxel_size, block_size, mask)
    seg = compute_segments(pack_keys(coords, grid), mask, v_max)
    return _voxel_info(xyz, mask, seg, v_max)


def voxelize_with_labels(xyz: torch.Tensor, mask: torch.Tensor,
                         labels: torch.Tensor, voxel_size: float,
                         block_size: float, v_max: int) -> VoxelInfo:
    """Class-pure voxelization (JAX ``ops/voxelize.py:183-203``): points of
    different labels never share a voxel; the segments come in voxel-key
    order, labels ascending within a voxel."""
    coords, grid = voxel_coords(xyz, voxel_size, block_size, mask)
    seg = compute_segments(pack_keys(coords, grid), mask, v_max, key2=labels)
    return _voxel_info(xyz, mask, seg, v_max)


def diff_to_center(xyz: torch.Tensor, centers: torch.Tensor,
                   seg: torch.Tensor) -> torch.Tensor:
    """Per-point offset from its voxel center (overflow points: xyz - 0).
    The gradient flows only into ``xyz``, as JAX's ``stop_gradient`` on
    the centers has it (JAX ``ops/voxelize.py:155-164``)."""
    return xyz - seg_ops.segment_unpool(centers.detach(), seg)


def voxel_majority_label(labels: torch.Tensor, mask: torch.Tensor,
                         seg: torch.Tensor, v_max: int,
                         num_classes: int) -> torch.Tensor:
    """Per-voxel majority-vote label (``ComputeVoxelLabel``; JAX
    ``ops/voxelize.py:167-181``): the valid points' one-hot labels summed
    per segment (the overflow segment ``v_max`` dropped), argmax with ties
    to the lowest class; an empty voxel gets 0.  labels [N] int ->
    [v_max] int32."""
    onehot = (labels.long()[:, None] == torch.arange(
        num_classes, device=labels.device)[None, :]) & mask[:, None]
    votes = seg_ops.segment_sum(onehot.to(torch.float32), seg, v_max)
    return torch.argmax(votes, dim=-1).to(torch.int32)
