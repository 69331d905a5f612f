"""The dense-pipeline pre-encoder of Semantic3D (mirror of
``pointcloudsegmentation_tpu.models.dense``).

``DenseFeats`` is the reference's ``dense_feats``
(model_pointnet_semantic3d.py:307-324): a fixed-K graph joins every
*sampled* point to its nearest points of the dense cloud
(``search.knn_in_support``); each edge ``[dxyz ‖ sampled feats ‖ dense
feats]`` goes through a growth MLP (``dense_feats``) and a masked max over
the dense neighbors; the pooled descriptor is concatenated before the
sampled features (train_gpn_semantic3d_dense.py:52-65)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops import search
from .layers import GrowthMLP

OUT_DIM = 48   # the pooled descriptor's width


class DenseFeats(nn.Module):
    """(dense cloud, sampled subset) -> sampled features [Ns, OUT_DIM +
    F], over the ``k`` nearest dense points.  ``feat_dim`` is the width of
    the sampled and the dense features alike; a sampled point without a
    valid dense neighbor pools to 0."""

    k = 16
    FC_DIMS = (16, 16, 16)

    def __init__(self, feat_dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dense_feats = GrowthMLP(3 + 2 * feat_dim, self.FC_DIMS, OUT_DIM,
                                     dtype=dtype)

    def forward(self, dense_xyz: torch.Tensor, dense_feats: torch.Tensor,
                dense_mask: torch.Tensor, sampled_xyz: torch.Tensor,
                sampled_feats: torch.Tensor, sampled_mask: torch.Tensor
                ) -> torch.Tensor:
        idx, _, valid = search.knn_in_support(
            sampled_xyz, sampled_mask, dense_xyz, dense_mask, self.k,
            chunk=min(1024, sampled_xyz.shape[0]))
        idx = idx.long()
        dxyz = dense_xyz[idx] - sampled_xyz[:, None, :]         # [Ns, K, 3]
        cen = sampled_feats[:, None, :].expand(-1, self.k, -1)
        edge = self.dense_feats(torch.cat([dxyz, cen, dense_feats[idx]],
                                          dim=-1))
        pooled = torch.where(valid[..., None], edge,
                             torch.full_like(edge, -1e30)).amax(dim=1)
        pooled = torch.where(valid.any(dim=1)[:, None], pooled,
                             torch.zeros_like(pooled))
        return torch.cat([pooled.to(sampled_feats.dtype), sampled_feats],
                         dim=-1)
