"""Model registry: config key -> end-to-end module (Morton sort + pyramid +
encoder + head), mirroring ``pointcloudsegmentation_tpu.train.model_zoo``
for the keys ``pointnet_s3dis`` and ``tiny_s3dis``."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..config import TrainConfig
from ..models.layers import SegClassifier, init_glorot_
from ..models.pointnet import (HEAD_DIM, S3DIS_ARCH, Arch, ConvSpec,
                               PointNetSegEncoder, StageSpec)
from ..ops import hierarchy as hier
from ..ops import morton

_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


class SegmentationModel(nn.Module):
    """Per-block pipeline: Morton sort -> voxel pyramid -> encoder -> head
    -> per-point logits in the caller's point order."""

    def __init__(self, encoder: PointNetSegEncoder, num_classes: int,
                 voxel_sizes: Tuple[float, ...], caps: Tuple[int, ...],
                 block_size: float, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.encoder = encoder
        self.head = SegClassifier(num_classes, HEAD_DIM,
                                  encoder.stage0_width, dtype=dtype)
        self.voxel_sizes = tuple(voxel_sizes)
        self.caps = tuple(caps)
        self.block_size = block_size

    def forward(self, xyz: torch.Tensor, feats: torch.Tensor,
                mask: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """xyz [N, 3], feats [N, F], mask [N] -> logits [N, C]."""
        cell = self.voxel_sizes[0] / 4.0
        xyz, mask, order, feats = morton.sort_block(
            xyz, mask, cell, self.block_size, feats)
        pyr = hier.build_pyramid(xyz, mask, self.voxel_sizes, self.caps,
                                 self.block_size, morton_sorted=True)
        gf, lf = self.encoder(pyr, feats)
        logits = self.head(gf, lf, train, generator)
        return logits[morton.inverse_permutation(order)]


def tiny_arch() -> Arch:
    """2-stage / 3-conv miniature of the flagship (the JAX ``tiny_s3dis``)."""
    return Arch(stages=(
        StageSpec(rescale=0.3, convs=(
            ConvSpec(radius=0.3, k=8, fc_dims=(4, 4), out=8),
            ConvSpec(radius=0.4, min_radius=0.3, k=6, embed=8,
                     fc_dims=(4, 4), out=8),
        ), pool_fc_dims=(4, 4), pool_out=8),
        StageSpec(rescale=0.9, convs=(
            ConvSpec(radius=0.9, k=8, embed=8, fc_dims=(4, 4), out=8),
        ), pool_fc_dims=None),
    ), global_dims=(8, 8), global_out=16)


_ARCHS = {"pointnet_s3dis": lambda: S3DIS_ARCH, "tiny_s3dis": tiny_arch}


def build_model(cfg: TrainConfig, generator: Optional[torch.Generator] = None,
                device="cpu", **encoder_kw) -> SegmentationModel:
    """Build ``cfg.model`` with ``cfg.compute_dtype`` compute.  Weights are
    Glorot-uniform draws from ``generator`` (on the CPU, so every device
    gets the same weights) or zeros without one, e.g. before loading a
    converted state_dict.  ``encoder_kw`` override PointNetSegEncoder
    settings (win_tile, win_window, search_chunk)."""
    if cfg.model not in _ARCHS:
        raise KeyError(f"unknown model '{cfg.model}'; ported: "
                       f"{sorted(_ARCHS)}")
    if cfg.compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}")
    dtype = _DTYPES[cfg.compute_dtype]
    d = cfg.data
    enc = PointNetSegEncoder(d.feat_dim, arch=_ARCHS[cfg.model](),
                             dtype=dtype, **encoder_kw)
    model = SegmentationModel(enc, d.num_classes, d.voxel_sizes, d.caps,
                              d.block_size, dtype=dtype)
    if generator is not None:
        init_glorot_(model, generator)
    return model.to(device)
