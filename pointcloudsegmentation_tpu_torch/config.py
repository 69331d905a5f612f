"""Dataclass config tree (mirror of ``pointcloudsegmentation_tpu.train.config``
for the parts the port uses).  A copy, not an import: the JAX package's
``train/__init__`` pulls in the JAX trainer."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class OptimConfig:
    """Adam + staircase exponential LR decay with a floor."""

    lr_init: float = 1e-3
    lr_clip: float = 1e-5
    decay_rate: float = 0.5
    decay_epoch: int = 50          # epochs per decay step
    epoch_steps: int = 2000        # optimizer steps per epoch


@dataclass(frozen=True)
class DataConfig:
    num_points: int = 8192         # static per-block point budget
    num_classes: int = 13
    block_size: float = 3.0
    voxel_sizes: Tuple[float, float] = (0.15, 0.45)
    caps: Tuple[int, int] = (4096, 1024)
    feat_dim: int = 12             # rgb(3) + covars(9) for S3DIS
    ignore_label: Optional[int] = None   # ScanNet masks label 0
    class_weights: Optional[Tuple[float, ...]] = None


@dataclass(frozen=True)
class TrainConfig:
    model: str = "pointnet_s3dis"  # registry key (train.model_zoo)
    data: DataConfig = field(default_factory=DataConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    batch_per_device: int = 1      # reference default --batch_size 1/GPU
    compute_dtype: str = "bfloat16"  # "float32" | "bfloat16" (params f32)
    diffusion_steps: int = 0       # graph_probs_diffusion (--use-diffusion)
    num_epochs: int = 100
    seed: int = 0                  # dropout streams derive from (seed, step)
    log_every: int = 120           # reference --log_step
    checkpoint_dir: Optional[str] = None
    keep_checkpoints: int = 500    # reference Saver(max_to_keep=500)


# S3DIS class weights (train_graph_pool_new.py:46-49)
S3DIS_CLASS_WEIGHTS = (
    2.80089331, 2.92693353, 2.94871211, 5.12748384, 5.07317114,
    5.18505001, 4.612535, 4.83436918, 4.1070838, 5.36530066, 4.64813137,
    5.26789713, 3.67803526)


def s3dis_config(**overrides) -> TrainConfig:
    """The S3DIS preset; see ``_replace`` for the override keywords."""
    base = TrainConfig(
        model="pointnet_s3dis",
        data=DataConfig(num_points=8192, num_classes=13, block_size=3.0,
                        voxel_sizes=(0.15, 0.45), caps=(4096, 1024),
                        feat_dim=12, class_weights=S3DIS_CLASS_WEIGHTS),
        optim=OptimConfig(epoch_steps=2000, decay_epoch=50))
    return _replace(base, overrides)


def scannet_config(**overrides) -> TrainConfig:
    """The ScanNet preset: no color, label 0 ignored and the rest shifted
    by -1 (train_gpn_scannet_new.py:66-88)."""
    base = TrainConfig(
        model="pointnet_scannet",
        data=DataConfig(num_points=8192, num_classes=20, block_size=3.0,
                        voxel_sizes=(0.15, 0.45), caps=(4096, 1024),
                        feat_dim=0, ignore_label=0),
        optim=OptimConfig(epoch_steps=5000, decay_epoch=50))
    return _replace(base, overrides)


def semantic3d_config(**overrides) -> TrainConfig:
    """The Semantic3D preset: 10 m blocks, rgb + intensity + covariance
    features.  Its scans label 0 unlabeled and 1..8 the 8 classes
    (``data/semantic3d.py``), so label 0 is ignored and the rest shifted by
    -1, as for ScanNet.  The JAX preset has no ignore label: it trains label
    0 as class 0 and drops class 8 (ROADMAP.md §3)."""
    base = TrainConfig(
        model="pointnet_semantic3d",
        data=DataConfig(num_points=10240, num_classes=8, block_size=10.0,
                        voxel_sizes=(0.25, 0.75), caps=(5120, 1280),
                        feat_dim=13, ignore_label=0),
        optim=OptimConfig(epoch_steps=2000, decay_epoch=50))
    return _replace(base, overrides)


def modelnet40_config(**overrides) -> TrainConfig:
    """The ModelNet40 preset: one label per cloud of 1024 unit-normalised
    points, the 9 covariance features (JAX ``train/config.py:92-98``)."""
    base = TrainConfig(
        model="gpn_modelnet40",
        data=DataConfig(num_points=1024, num_classes=40, block_size=2.0,
                        voxel_sizes=(0.2, 0.5), caps=(384, 96), feat_dim=9),
        optim=OptimConfig(epoch_steps=2460, decay_epoch=50))
    return _replace(base, overrides)


CONFIGS = {
    "s3dis": s3dis_config,
    "scannet": scannet_config,
    "semantic3d": semantic3d_config,
    "modelnet40": modelnet40_config,
}


def require_device(device: str) -> torch.device:
    """``device`` as a torch device; raises for a CUDA device when there is
    no card (the entry points have no CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this entry point runs on the "
                           "card unless --device cpu is given")
    return device


def _replace(cfg: TrainConfig, overrides: dict) -> TrainConfig:
    """``data_<field>=`` overrides a DataConfig field, ``optim_<field>=`` an
    OptimConfig field, any other keyword a TrainConfig field."""
    data_over = {k[5:]: v for k, v in overrides.items()
                 if k.startswith("data_")}
    optim_over = {k[6:]: v for k, v in overrides.items()
                  if k.startswith("optim_")}
    top = {k: v for k, v in overrides.items()
           if not k.startswith(("data_", "optim_"))}
    if data_over:
        top["data"] = dataclasses.replace(cfg.data, **data_over)
    if optim_over:
        top["optim"] = dataclasses.replace(cfg.optim, **optim_over)
    return dataclasses.replace(cfg, **top)
