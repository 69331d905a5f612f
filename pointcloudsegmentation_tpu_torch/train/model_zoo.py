"""Model registry: config key -> end-to-end module (Morton sort + pyramid +
encoder + head), mirroring ``pointcloudsegmentation_tpu.train.model_zoo``
for its ``PointNetSegEncoder`` keys (``_ARCHS``), ``tiny_s3dis``, the ECD,
PGNet and GPN segmentation nets, the PointNet++ baseline and the four
``template_*`` harness keys (``_ENCODERS``), the refine cascade
``refine_s3dis`` (``RefineCascadeModel``: [2, N, C] logits, refine row
first), the ModelNet40 classifier ``gpn_modelnet40``
(``_CLASSIFIERS``: unsorted pyramid + encoder + ``ClassifierHead`` -> one
row of logits per cloud), and Semantic3D's two pipelines with inputs
beyond the block: ``dense_semantic3d`` (``DenseSegModel``: the dense
cloud pooled onto the sampled points first) and ``context_semantic3d``
(``models.context.ContextFusionModel``: a 50 m context cloud beside the
block).  Such a model names the batch fields it takes after (xyz, feats,
mask) in ``extra_keys``."""
from __future__ import annotations

from functools import partial
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from .. import data as data_lib
from ..config import TrainConfig
from ..data import semantic3d
from ..models import dense as dense_lib
from ..models import ecd, gpn, template
from ..models.context import ContextFusionModel
from ..models.layers import ProbsDiffusion, SegClassifier, init_glorot_
from ..models.pointnet import (HEAD_DIM, OV_POOL_SIZE, S3DIS_ARCH,
                               S3DIS_BASELINE20_ARCH,
                               S3DIS_CONCAT10_DECONV_ARCH, S3DIS_EMBED_ARCH,
                               SCANNET_ARCH, SEMANTIC3D_ARCH,
                               SEMANTIC3D_DILATE_ARCH, Arch, ConvSpec,
                               PointNet2Baseline, PointNetSegEncoder,
                               StageSpec)
from ..ops import hierarchy as hier
from ..ops import morton, search
from ..utils import profiling

_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}
# the diffusion path's neighborhood (JAX train/model_zoo.py:64-65) and the
# cascade's class-pure voxel (JAX :95)
DIFFUSION_RADIUS, DIFFUSION_K = 0.1, 8
REFINE_VOXEL = 0.75


class ClassificationModel(nn.Module):
    """Per-cloud pipeline for ModelNet40 (JAX ``train/model_zoo.py:
    186-202``): the voxel pyramid of the cloud as it comes (no Morton sort,
    so level 0 takes the global search), the encoder's cloud descriptor,
    then ``ClassifierHead`` -> logits [C]."""

    def __init__(self, encoder: nn.Module, num_classes: int,
                 voxel_sizes: Tuple[float, ...], caps: Tuple[int, ...],
                 block_size: float, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.encoder = encoder
        self.head = gpn.ClassifierHead(num_classes, encoder.out_width,
                                       dtype=dtype)
        self.voxel_sizes = tuple(voxel_sizes)
        self.caps = tuple(caps)
        self.block_size = block_size

    def forward(self, xyz: torch.Tensor, feats: torch.Tensor,
                mask: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """xyz [N, 3], feats [N, F], mask [N] -> logits [C]."""
        pyr = hier.build_pyramid(xyz, mask, self.voxel_sizes, self.caps,
                                 self.block_size)
        vec = self.encoder(pyr, feats)
        return self.head(vec[None, :], train, generator)[0]


class SegmentationModel(nn.Module):
    """Per-block pipeline: Morton sort -> voxel pyramid -> encoder -> head
    -> per-point logits in the caller's point order.  The head is sized
    from what the encoder returns: premixed on the factored head's
    head_dim columns, else with ``class_mlp1`` on the wide decoder
    output.  Any encoder with ``out_width``, ``stage0_width`` and
    ``head_dim`` (None: unfactored) that maps (pyramid, feats) to (head
    input, stage-0 feats) will do.

    ``diffusion_steps > 0`` (the JAX ``--use_diffusion`` path,
    ``train/model_zoo.py:63-69``) smooths the float32 softmax over each
    point's ``DIFFUSION_K`` nearest neighbors within ``DIFFUSION_RADIUS``
    (``search.radius_neighbors`` on the sorted points, before the inverse
    permutation) with ``ProbsDiffusion`` and returns
    ``log(max(probs, 1e-12))``."""

    def __init__(self, encoder: nn.Module, num_classes: int,
                 voxel_sizes: Tuple[float, ...], caps: Tuple[int, ...],
                 block_size: float, dtype: Optional[torch.dtype] = None,
                 diffusion_steps: int = 0):
        super().__init__()
        self.encoder = encoder
        self.head = SegClassifier(num_classes, encoder.out_width,
                                  encoder.stage0_width,
                                  premixed=encoder.head_dim is not None,
                                  dtype=dtype)
        self.voxel_sizes = tuple(voxel_sizes)
        self.caps = tuple(caps)
        self.block_size = block_size
        if diffusion_steps > 0:
            self.diffusion = ProbsDiffusion(diffusion_steps)

    def forward(self, xyz: torch.Tensor, feats: torch.Tensor,
                mask: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """xyz [N, 3], feats [N, F], mask [N] -> logits [N, C]."""
        cell = self.voxel_sizes[0] / 4.0
        xyz, mask, order, feats = morton.sort_block(
            xyz, mask, cell, self.block_size, feats)
        pyr = hier.build_pyramid(xyz, mask, self.voxel_sizes, self.caps,
                                 self.block_size, morton_sorted=True)
        with profiling.span("pcs.encoder"):
            gf, lf = self.encoder(pyr, feats)
        logits = self.head(gf, lf, train, generator)
        if hasattr(self, "diffusion"):
            n = xyz.shape[0]
            nbr = search.radius_neighbors(xyz, mask, DIFFUSION_RADIUS,
                                          DIFFUSION_K, chunk=min(1024, n))
            probs = self.diffusion(torch.softmax(logits.float(), dim=-1),
                                   nbr)
            logits = torch.log(probs.clamp(min=1e-12))
        return logits[morton.inverse_permutation(order)]


class DenseSegModel(SegmentationModel):
    """The dense pipeline (JAX ``train/model_zoo.py:145-183``):
    ``DenseFeats`` (``dense_feats``) pools each sampled point's 16 nearest
    dense points onto its features, before the Morton sort; then the
    ``SegmentationModel`` pipeline on the enriched sampled points, without
    a diffusion tail.  ``encoder`` takes ``dense.OUT_DIM`` pooled
    columns before the block's ``feat_dim`` features."""

    extra_keys = ("dense_xyz", "dense_feats", "dense_mask")

    def __init__(self, encoder: nn.Module, num_classes: int,
                 voxel_sizes: Tuple[float, ...], caps: Tuple[int, ...],
                 block_size: float, dtype: Optional[torch.dtype] = None):
        super().__init__(encoder, num_classes, voxel_sizes, caps,
                         block_size, dtype=dtype)
        self.dense_feats = dense_lib.DenseFeats(
            encoder.feat_dim - dense_lib.OUT_DIM, dtype=dtype)

    def forward(self, xyz: torch.Tensor, feats: torch.Tensor,
                mask: torch.Tensor, dense_xyz: torch.Tensor,
                dense_feats: torch.Tensor, dense_mask: torch.Tensor,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """xyz [N, 3], feats [N, F], mask [N] of the sampled points,
        dense_xyz [Nd, 3], dense_feats [Nd, F], dense_mask [Nd] -> logits
        [N, C]."""
        feats = self.dense_feats(dense_xyz, dense_feats, dense_mask, xyz,
                                 feats, mask)
        return super().forward(xyz, feats, mask, train, generator)


class RefineCascadeModel(nn.Module):
    """The two-model refine cascade (JAX ``train/model_zoo.py:76-142``):
    the base encoder and its unfactored head give the base logits; their
    argmax (no gradient) builds a class-pure pyramid of ``REFINE_VOXEL``
    voxels capped at the last cap (``hier.build_class_pyramid``);
    ``SemanticPoolRefine`` runs on it from the base global features,
    detached, so the base encoder takes no gradient through the refine
    net's input; ``refine_head`` classifies [refine global ‖ base global]
    with the [base local ‖ refine local] skip.  Returns [2, N, C] (refine,
    base) in the caller's point order."""

    def __init__(self, encoder: nn.Module, num_classes: int,
                 voxel_sizes: Tuple[float, ...], caps: Tuple[int, ...],
                 block_size: float, dtype: Optional[torch.dtype] = None,
                 search_chunk: int = 1024, windowed: bool = True):
        super().__init__()
        self.encoder = encoder
        self.head = SegClassifier(num_classes, encoder.out_width,
                                  encoder.stage0_width, premixed=False,
                                  dtype=dtype)
        self.refine = template.SemanticPoolRefine(
            encoder.out_width, search_chunk=search_chunk, dtype=dtype,
            windowed=windowed)
        self.refine_head = SegClassifier(
            num_classes, self.refine.global_width + encoder.out_width,
            encoder.stage0_width + self.refine.local_width, premixed=False,
            dtype=dtype)
        self.voxel_sizes = tuple(voxel_sizes)
        self.caps = tuple(caps)
        self.block_size = block_size
        self.refine_cap = self.caps[-1]

    def forward(self, xyz: torch.Tensor, feats: torch.Tensor,
                mask: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """xyz [N, 3], feats [N, F], mask [N] -> logits [2, N, C]."""
        cell = self.voxel_sizes[0] / 4.0
        xyz, mask, order, feats = morton.sort_block(
            xyz, mask, cell, self.block_size, feats)
        pyr = hier.build_pyramid(xyz, mask, self.voxel_sizes, self.caps,
                                 self.block_size, morton_sorted=True)
        gf, lf = self.encoder(pyr, feats)
        base = self.head(gf, lf, train, generator)
        preds = base.detach().argmax(-1).to(torch.int32)
        cpyr = hier.build_class_pyramid(xyz, mask, preds, REFINE_VOXEL,
                                        self.refine_cap, self.block_size,
                                        morton_sorted=True)
        rgf, rlf = self.refine(cpyr, gf.detach())
        refined = self.refine_head(torch.cat([rgf, gf], dim=-1),
                                   torch.cat([lf, rlf], dim=-1), train,
                                   generator)
        out = torch.stack([refined, base])
        return out[:, morton.inverse_permutation(order)]


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


_ARCHS = {"pointnet_s3dis": lambda: S3DIS_ARCH,
          "pointnet_scannet": lambda: SCANNET_ARCH,
          "pointnet_semantic3d": lambda: SEMANTIC3D_ARCH,
          "pointnet_semantic3d_dilate": lambda: SEMANTIC3D_DILATE_ARCH,
          "pointnet_baseline20": lambda: S3DIS_BASELINE20_ARCH,
          "pointnet_concat10_deconv": lambda: S3DIS_CONCAT10_DECONV_ARCH,
          "pointnet_embed_only": lambda: S3DIS_EMBED_ARCH,
          "tiny_s3dis": tiny_arch}

# the other encoders of the JAX registry (train/model_zoo.py:305-324),
# each called as (feat_dim, search_chunk=, dtype=)
_ENCODERS = {
    "pointnet2_s3dis": PointNet2Baseline,
    "ecd_scannet": partial(ecd.ECDSegModel, specs=ecd.SCANNET_ECD_SPEC),
    "ecd_s3dis": partial(ecd.ECDSegModel, specs=ecd.S3DIS_ECD_SPEC),
    "pgnet_v3": partial(ecd.ECDSegModel, specs=ecd.PGNET_V3_SPEC),
    "pgnet_v4": partial(ecd.ECDSegModel, specs=ecd.PGNET_V4_SPEC),
    "pgnet_v5": partial(ecd.ECDSegModel, specs=ecd.PGNET_V5_SPEC),
    "pgnet_v6": ecd.PGNetV6,
    "pgnet_v7": ecd.PGNetV7,
    "pgnet_v8": ecd.PGNetHybrid,
    "gpn_seg": gpn.GPNSegModel,
    **{f"template_{conv}": partial(template.TemplateSegModel, conv=conv)
       for conv in template.CONVS},
}

# the refine cascade (JAX train/model_zoo.py:359-364): its base encoder,
# the 2-stage ECD net, called as the _ENCODERS are
_CASCADES = {"refine_s3dis": partial(ecd.ECDSegModel,
                                     specs=ecd.S3DIS_ECD_SPEC[:2])}

# the classification keys (JAX train/model_zoo.py:365-367), encoders called
# as the _ENCODERS are
_CLASSIFIERS = {"gpn_modelnet40": gpn.GPNClassModel}

def _dense_encoder(feat_dim: int, arch: Arch = SEMANTIC3D_DILATE_ARCH,
                   dtype: Optional[torch.dtype] = None,
                   **encoder_kw) -> PointNetSegEncoder:
    """The dense model's encoder (JAX train/model_zoo.py:353-358) on the
    pooled dense descriptor before the block's features: the JAX build
    passes search_chunk only, so the field defaults hold, per-point
    overflow slots and the unfactored head."""
    return PointNetSegEncoder(dense_lib.OUT_DIM + feat_dim, arch=arch,
                              dtype=dtype, **encoder_kw)


class _Pipeline(NamedTuple):
    """A model with inputs beyond the block: its ``encoder``, called as
    (feat_dim, dtype=, **encoder_kw); its ``model``, called as (encoder,
    num_classes, voxel_sizes, caps, block_size, dtype=), without a
    diffusion tail; and ``blocks_fn``, its read of loaded pkls of prepared
    blocks, (split, loaded pkl) -> block dicts."""
    encoder: Callable[..., nn.Module]
    model: Callable[..., nn.Module]
    blocks_fn: Callable[..., List[Dict]]


# Semantic3D's two pipelines (JAX train/model_zoo.py:353-376, their reads
# as the JAX CLI picks them, train/cli.py:113-124)
_PIPELINES = {
    "dense_semantic3d": _Pipeline(_dense_encoder, DenseSegModel,
                                  semantic3d.dense_blocks_from_list),
    "context_semantic3d": _Pipeline(
        partial(ecd.ECDSegModel, specs=ecd.S3DIS_ECD_SPEC),
        ContextFusionModel, semantic3d.context_blocks_from_list),
}


def blocks_fn_for(cfg: TrainConfig, config_name: str):
    """(split, loaded pkl) -> block dicts for ``cfg.model``: a pipeline's
    own read of its prepared blocks, else the config's dataset read
    (``data.blocks_fn_for``)."""
    if cfg.model in _PIPELINES:
        return _PIPELINES[cfg.model].blocks_fn
    return data_lib.blocks_fn_for(cfg, config_name)


def read_fn_for(cfg: TrainConfig, config_name: str):
    """The Provider read_fn (split, pkl path) -> block dicts for
    ``cfg.model``: a pipeline's own read of its prepared pkls, else the
    config's dataset read (``data.read_fn_for``)."""
    if cfg.model in _PIPELINES:
        return data_lib.pkl_read_fn(_PIPELINES[cfg.model].blocks_fn)
    return data_lib.read_fn_for(cfg, config_name)


def build_model(cfg: TrainConfig, generator: Optional[torch.Generator] = None,
                device="cuda", windowed: bool = True,
                **encoder_kw) -> nn.Module:
    """Build ``cfg.model`` with ``cfg.compute_dtype`` compute.  Weights are
    Glorot-uniform draws from ``generator`` (on the CPU, so every device
    gets the same weights) or zeros without one, e.g. before loading a
    converted state_dict; the template's trainable anchors start at the
    sphere k-means and ``ProbsDiffusion``'s ``alpha`` at 0 either way.
    The model lives on ``device``: the card unless the caller asks for the
    CPU.  ``encoder_kw`` override PointNetSegEncoder settings, also for
    ``dense_semantic3d``: any field of the encoder (``search_chunk``,
    ``cand_k``, ``win_cand_k``, ``sel_mode``, ``ov_slots``,
    ``ov_pool_size``, ``ov_mode="edges"``, ``fast_conv``, ``remat``,
    ``win_tile``, ``win_window``, ...).  They take the place of the JAX
    build's environment variables, which the port does not read:
    ``PCS_SEL_MODE`` -> ``sel_mode``, ``PCS_CAND_K`` -> ``win_cand_k``,
    ``PCS_OV_POOL`` -> ``ov_pool_size`` (default 256 for an ``_ARCHS``
    key, as ``PCS_OV_POOL``'s), ``PCS_REMAT=1`` -> ``remat=True``,
    ``PCS_WIN_WINDOW`` -> ``win_window`` (and ``win_tile`` where the
    window divides 256).  The other encoders take ``search_chunk``
    only, the one setting the JAX build passes them.  A ``_PIPELINES``
    key gives its model
    (``dense_semantic3d`` a ``DenseSegModel`` over the unfactored
    ``SEMANTIC3D_DILATE_ARCH`` encoder with per-point overflow slots,
    ``context_semantic3d`` a ``ContextFusionModel`` with the config's
    voxel sizes, caps and block size), a ``_CLASSIFIERS`` key a
    ``ClassificationModel``, ``refine_s3dis`` a ``RefineCascadeModel``,
    any other a ``SegmentationModel`` with ``cfg.diffusion_steps``.  The
    head is factored (head_dim 512, premixed) only for a
    PointNetSegEncoder of an ``_ARCHS`` key whose decoder is not the
    deconv, as the JAX build_model factors it (train/model_zoo.py:
    346-353).  ``cfg.diffusion_steps`` on a ``_PIPELINES`` key (no
    diffusion tail; the JAX build ignores it) raises.

    ``windowed=False`` builds the model with the exact global neighbor
    search on every level (the scene eval's ``--exact-search``): it
    reaches every encoder's dispatch between the windowed and the global
    search (``PointNetSegEncoder._stage_neighborhoods`` and
    ``search.band_neighbors_auto``), where the JAX package reads
    ``PCS_DISABLE_WINDOWED=1`` from the environment."""
    others = {**_ENCODERS, **_CASCADES, **_CLASSIFIERS}
    known = {**_ARCHS, **_PIPELINES, **others}
    if cfg.model not in known:
        raise KeyError(f"unknown model '{cfg.model}'; ported: "
                       f"{sorted(known)}")
    if cfg.compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}")
    dtype = _DTYPES[cfg.compute_dtype]
    d = cfg.data
    if cfg.model in _PIPELINES:
        if cfg.diffusion_steps:
            raise ValueError(f"{cfg.model} has no diffusion tail "
                             "(--use-diffusion)")
        p = _PIPELINES[cfg.model]
        model = p.model(p.encoder(d.feat_dim, dtype=dtype,
                                  windowed=windowed, **encoder_kw),
                        d.num_classes, d.voxel_sizes, d.caps, d.block_size,
                        dtype=dtype)
        return _place(model, generator, device)
    if cfg.model in others:
        extra = set(encoder_kw) - {"search_chunk"}
        if extra:
            raise TypeError(f"{cfg.model} takes only search_chunk, got "
                            f"{sorted(extra)}")
        enc = others[cfg.model](d.feat_dim, dtype=dtype, windowed=windowed,
                                **encoder_kw)
    else:
        arch = _ARCHS[cfg.model]()
        kw = {"ov_pool_size": OV_POOL_SIZE, **encoder_kw}
        enc = PointNetSegEncoder(
            d.feat_dim, arch=arch,
            head_dim=None if arch.decoder == "deconv" else HEAD_DIM,
            dtype=dtype, windowed=windowed, **kw)
    common = (enc, d.num_classes, d.voxel_sizes, d.caps, d.block_size)
    if cfg.model in _CLASSIFIERS:
        model = ClassificationModel(*common, dtype=dtype)
    elif cfg.model in _CASCADES:
        model = RefineCascadeModel(*common, dtype=dtype, windowed=windowed,
                                   **encoder_kw)
    else:
        model = SegmentationModel(*common, dtype=dtype,
                                  diffusion_steps=cfg.diffusion_steps)
    return _place(model, generator, device)


def _place(model: nn.Module, generator: Optional[torch.Generator],
           device) -> nn.Module:
    if generator is not None:
        init_glorot_(model, generator)
    return model.to(device)
