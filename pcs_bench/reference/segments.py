"""Deterministic masked segment reductions: a frozen copy of the port's
``ops/segments.py`` (stable sort + ``segment_reduce``, no float atomics)."""
from __future__ import annotations

import torch


def segment_count(seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Number of points in each segment, float32 [V]."""
    cnt = torch.bincount(seg.long(), minlength=num_segments + 1)
    return cnt[:num_segments].to(torch.float32)


def segment_sum(data: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """[N, F] summed into [V, F]; overflow ids (== V) are dropped."""
    seg = seg.long()
    order = torch.sort(seg, stable=True).indices
    lengths = torch.bincount(seg, minlength=num_segments + 1)
    out = torch.segment_reduce(data[order], "sum", lengths=lengths,
                               axis=0, unsafe=True)
    return out[:num_segments]


def segment_mean(data: torch.Tensor, seg: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Mean per segment; empty segments produce 0."""
    s = segment_sum(data, seg, num_segments)
    cnt = segment_count(seg, num_segments)[:, None]
    return s / cnt.clamp(min=1.0)


def segment_max(data: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Max per segment; empty segments produce 0."""
    idx = seg.long()[:, None].expand(-1, data.shape[1])
    out = data.new_zeros((num_segments + 1, data.shape[1]))
    out = out.scatter_reduce(0, idx, data, "amax", include_self=False)
    return out[:num_segments]


def segment_unpool(voxel_feats: torch.Tensor,
                   seg: torch.Tensor) -> torch.Tensor:
    """Broadcast voxel features back to their member points; overflow ids
    read a zero row.  voxel_feats: [V, F], seg: [N] -> [N, F]."""
    pad = voxel_feats.new_zeros((1,) + tuple(voxel_feats.shape[1:]))
    return torch.cat([voxel_feats, pad], dim=0)[seg.long()]
