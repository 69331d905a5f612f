"""Dataclass config tree (mirror of ``pointcloudsegmentation_tpu.train.config``
for the parts the port uses).  A copy, not an import: the JAX package's
``train/__init__`` pulls in the JAX trainer."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


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
    compute_dtype: str = "bfloat16"  # "float32" | "bfloat16" (params f32)


# S3DIS class weights (train_graph_pool_new.py:46-49)
S3DIS_CLASS_WEIGHTS = (
    2.80089331, 2.92693353, 2.94871211, 5.12748384, 5.07317114,
    5.18505001, 4.612535, 4.83436918, 4.1070838, 5.36530066, 4.64813137,
    5.26789713, 3.67803526)


def s3dis_config(**overrides) -> TrainConfig:
    """The S3DIS preset; ``data_<field>=`` overrides a DataConfig field,
    any other keyword a TrainConfig field."""
    base = TrainConfig(
        model="pointnet_s3dis",
        data=DataConfig(num_points=8192, num_classes=13, block_size=3.0,
                        voxel_sizes=(0.15, 0.45), caps=(4096, 1024),
                        feat_dim=12, class_weights=S3DIS_CLASS_WEIGHTS))
    data_over = {k[5:]: v for k, v in overrides.items()
                 if k.startswith("data_")}
    top = {k: v for k, v in overrides.items() if not k.startswith("data_")}
    if data_over:
        top["data"] = dataclasses.replace(base.data, **data_over)
    return dataclasses.replace(base, **top)
