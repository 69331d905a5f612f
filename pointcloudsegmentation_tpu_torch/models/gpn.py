"""GPN (Gaussian-anchored location-weighted) models (mirror of
``pointcloudsegmentation_tpu.models.gpn``): per-stage anchored convs
(``GPNConv``) sharing one set of location weights ``lw = exp(sxyz · pmiu)``
per neighborhood, DenseNet-style feature growth, a voxel max-pool between
stages, and either

- ``GPNSegModel``: the segmentation decoder (global max at the top, tiled
  and unpooled back down with each stage's features), for ``gpn_seg``;
- ``GPNClassModel``: one cloud descriptor, the global max of every stage's
  fc and local features, for ``ClassifierHead`` (``gpn_modelnet40``).

Each stage runs one ``search.band_neighbors_auto`` call (the windowed
search with per-point overflow slots on a Morton-sorted, tile-aligned
level, else the global one) with the JAX stage's candidate pool of 4k.
Dtypes follow jnp's promotion: the anchored convs compute in float32, each
Dense returns the compute dtype, and a stage-0 concat with the raw float32
input features is float32, so stage 0 gathers float32 rows and the later
stages gather the compute dtype.  Submodule names are the flax ones.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from ..ops import hierarchy as hier
from ..ops.types import Pyramid
# the JAX _masked_max (:100-101) is ECD's masked global max
from .ecd import _masked_global_max as _masked_max
from .ecd import _search_one
from .layers import Dense, GPNConv, SegClassifier


@dataclass(frozen=True)
class GPNStageSpec:
    radius: float
    k: int
    gxyz_dim: int = 8
    gc_dims: Tuple[int, ...] = (8, 16, 32)
    fc_dims: Tuple[int, ...] = (8, 16, 32)
    gfc_dims: Tuple[int, ...] = (32, 32, 32)
    final_dim: int = 32


# graph_conv_pool_model_v1's stage dims (model.py:1199-1218); radii sized
# for unit-sphere-normalized ModelNet40 clouds
MODELNET_SPEC = (
    GPNStageSpec(radius=0.12, k=16, gxyz_dim=8, gc_dims=(8, 16, 32),
                 fc_dims=(8, 16, 32), gfc_dims=(32, 32, 32), final_dim=32),
    GPNStageSpec(radius=0.3, k=16, gxyz_dim=8,
                 gc_dims=(32, 32, 32, 64, 64, 64),
                 fc_dims=(32, 32, 32, 64, 64, 64),
                 gfc_dims=(128, 128, 128), final_dim=128),
    GPNStageSpec(radius=0.6, k=16, gxyz_dim=8, gc_dims=(128, 128, 256),
                 fc_dims=(128, 128, 256), gfc_dims=(256, 256),
                 final_dim=256),
)


class GPNStage(nn.Module):
    """One anchored-conv stage (JAX ``models/gpn.py:55-97``): the xyz conv
    (``xyz_gc``, which makes the stage's lw/lw_sum) and ReLU ``xyz_fc``,
    prepended to the input features; per (gc, fc) dim a feats-mode
    ``GPNConv`` (``gc_{i}``, the shared lw) on the
    running features, concatenated before them into ReLU ``fc_{i}``, whose
    output joins the running features first; then a plain ReLU MLP
    (``gfc_{i}``) and ``gfc_final`` on ``[cfeats ‖ dxyz]``.  Returns
    (fc_final, cfeats); ``lf_width`` is cfeats' width."""

    def __init__(self, spec: GPNStageSpec, in_dim: int, m: int = 26,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.spec = spec
        g = spec.gxyz_dim
        self.xyz_gc = GPNConv(0, m, g, mode="xyz", no_sum=True)
        self.xyz_fc = Dense(m * g, g, dtype=dtype)
        w = g + in_dim
        for i, (gd, fd) in enumerate(zip(spec.gc_dims, spec.fc_dims)):
            self.add_module(f"gc_{i}", GPNConv(w, m, gd, mode="feats",
                                               no_sum=True, shared_lw=True))
            self.add_module(f"fc_{i}", Dense(m * gd + w, fd, dtype=dtype))
            w += fd
        self.lf_width = w
        w += 3
        for i, gfd in enumerate(spec.gfc_dims):
            self.add_module(f"gfc_{i}", Dense(w, gfd, dtype=dtype))
            w = gfd
        self.gfc_final = Dense(w, spec.final_dim, dtype=dtype)

    def forward(self, xyz: torch.Tensor, mask: torch.Tensor,
                dxyz: torch.Tensor, feats: torch.Tensor,
                is_sorted: bool = False, chunk: int = 1024,
                windowed: bool = True):
        sp = self.spec
        nbr, sxyz = _search_one(xyz, mask, sp.radius, sp.k, is_sorted, chunk,
                                windowed)
        xyz_gc, lw, lw_sum = self.xyz_gc(sxyz, None, nbr)
        cfeats = torch.cat([torch.relu(self.xyz_fc(xyz_gc)), feats], dim=-1)
        for i in range(len(sp.gc_dims)):
            gc, _, _ = getattr(self, f"gc_{i}")(sxyz, cfeats, nbr, lw=lw,
                                                lw_sum=lw_sum)
            fc = torch.relu(getattr(self, f"fc_{i}")(
                torch.cat([gc, cfeats], dim=-1)))
            cfeats = torch.cat([fc, cfeats], dim=-1)
        x = torch.cat([cfeats, dxyz], dim=-1)
        for i in range(len(sp.gfc_dims)):
            x = torch.relu(getattr(self, f"gfc_{i}")(x))
        return self.gfc_final(x), cfeats


class _GPNStages(nn.Module):
    """The stages and their voxel max-pools, shared by both models: the
    feature widths, and a forward that returns every stage's (fc, lf)."""

    def __init__(self, feat_dim: int, specs, m: int, search_chunk: int,
                 dtype: Optional[torch.dtype], windowed: bool = True):
        super().__init__()
        self.specs = tuple(specs)
        self.m, self.search_chunk, self.dtype = m, search_chunk, dtype
        self.windowed = windowed
        self.widths = []   # (fc, lf) per stage
        w = feat_dim
        for s, sp in enumerate(self.specs):
            stage = GPNStage(sp, w, m, dtype=dtype)
            self.add_module(f"stage{s}", stage)
            self.widths.append((sp.final_dim, stage.lf_width))
            w = sp.final_dim

    def stages(self, pyramid: Pyramid, feats: torch.Tensor):
        fcs, lfs = [], []
        cur = feats
        for s in range(len(self.specs)):
            lvl = pyramid.levels[s]
            dxyz = pyramid.dxyz[s] if s < len(pyramid.dxyz) else lvl.xyz
            fc, lf = getattr(self, f"stage{s}")(
                lvl.xyz, lvl.mask, dxyz, cur,
                is_sorted=pyramid.level_sorted(s), chunk=self.search_chunk,
                windowed=self.windowed)
            fcs.append(fc)
            lfs.append(lf)
            if s < len(self.specs) - 1:
                cur = hier.pool_max(fc, pyramid, s)
        return fcs, lfs


class GPNClassModel(_GPNStages):
    """``graph_conv_pool_model_v1`` (JAX ``models/gpn.py:104-134``): the
    stages, then the global max of every stage's fc and of every stage's
    local features, concatenated into one cloud descriptor of
    ``out_width`` columns."""

    def __init__(self, feat_dim: int, specs=MODELNET_SPEC, m: int = 26,
                 search_chunk: int = 1024,
                 dtype: Optional[torch.dtype] = None, windowed: bool = True):
        super().__init__(feat_dim, specs, m, search_chunk, dtype, windowed)
        self.out_width = sum(fc + lf for fc, lf in self.widths)

    def forward(self, pyramid: Pyramid, feats: torch.Tensor) -> torch.Tensor:
        fcs, lfs = self.stages(pyramid, feats)
        masks = [pyramid.levels[s].mask for s in range(len(fcs))]
        parts = [_masked_max(fc, mk) for fc, mk in zip(fcs, masks)]
        parts += [_masked_max(lf, mk) for lf, mk in zip(lfs, masks)]
        return torch.cat(parts, dim=0)


class GPNSegModel(_GPNStages):
    """The GPN segmentation net (``graph_conv_pool_v7_nosum_lpmiu``
    family; JAX ``models/gpn.py:137-169``): the stages, the global max of
    the top stage's fc tiled over its points beside its fc and local
    features, then unpooled level by level with each stage's (fc, lf).
    Returns (decoder output, [fc0 ‖ lf0]) for the unfactored
    ``SegClassifier``: ``out_width``, ``stage0_width``, ``head_dim =
    None``."""

    head_dim = None

    def __init__(self, feat_dim: int, specs=MODELNET_SPEC, m: int = 26,
                 search_chunk: int = 1024,
                 dtype: Optional[torch.dtype] = None, windowed: bool = True):
        super().__init__(feat_dim, specs, m, search_chunk, dtype, windowed)
        fc_top = self.widths[-1][0]
        self.out_width = fc_top + sum(fc + lf for fc, lf in self.widths)
        self.stage0_width = sum(self.widths[0])

    def forward(self, pyramid: Pyramid, feats: torch.Tensor):
        fcs, lfs = self.stages(pyramid, feats)
        top = len(fcs) - 1
        gvec = _masked_max(fcs[top], pyramid.levels[top].mask)
        up = gvec[None, :].expand(fcs[top].shape[0], -1)
        up = torch.cat([up, fcs[top], lfs[top]], dim=-1)
        for s in range(top - 1, -1, -1):
            up = torch.cat([hier.unpool(up, pyramid, s), fcs[s], lfs[s]],
                           dim=-1)
        return up, torch.cat([fcs[0], lfs[0]], dim=-1)


class ClassifierHead(nn.Module):
    """``model_classifier_v1`` (JAX ``models/gpn.py:172-183``): ReLU
    ``class_fc1`` (512) -> concat(input) -> dropout -> ReLU ``class_fc2``
    (256) -> concat(input) -> dropout -> ``class_fc3`` logits.  Dropout
    (rate 0.3) runs only with ``train=True`` and draws from the given
    generator, as ``SegClassifier``'s does."""

    def __init__(self, num_classes: int, in_dim: int,
                 dropout_rate: float = 0.3,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.class_fc1 = Dense(in_dim, 512, dtype=dtype)
        self.class_fc2 = Dense(512 + in_dim, 256, dtype=dtype)
        self.class_fc3 = Dense(256 + in_dim, num_classes, dtype=dtype)

    _dropout = SegClassifier._dropout

    def forward(self, feats: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = torch.cat([torch.relu(self.class_fc1(feats)), feats], dim=-1)
        if train:
            x = self._dropout(x, generator)
        x = torch.cat([torch.relu(self.class_fc2(x)), feats], dim=-1)
        if train:
            x = self._dropout(x, generator)
        return self.class_fc3(x)
