"""The system under test, built from a configuration file: the port's
``Trainer`` with the configuration's model and the benchmark's weights.
The harness imports the port through this module and the drivers only."""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from pointcloudsegmentation_tpu_torch.config import (DataConfig,
                                                     OptimConfig,
                                                     TrainConfig)
from pointcloudsegmentation_tpu_torch.train.loop import Trainer, TrainState

from .reference import model as ref_model
from .weights import glorot_flat, torch_seed


def train_config(cfg: Dict, seed: int) -> TrainConfig:
    """The port's config for configuration ``cfg``; the dropout streams
    derive from ``seed``."""
    return TrainConfig(
        model=cfg["registry_key"],
        data=DataConfig(num_classes=cfg["num_classes"],
                        block_size=cfg["block_size"],
                        voxel_sizes=tuple(cfg["voxel_sizes"]),
                        caps=tuple(cfg["caps"]), feat_dim=cfg["feat_dim"],
                        class_weights=tuple(cfg["class_weights"])),
        optim=OptimConfig(**cfg["optim"]),
        compute_dtype=cfg["compute_dtype"],
        seed=train_seed(seed))


def train_seed(seed: int) -> int:
    """The training seed (dropout streams) of run seed ``seed``."""
    return torch_seed(seed, 3) & 0x7FFFFFFF


def reference_leaves(cfg: Dict) -> List[ref_model.Leaf]:
    """The flat layout of the configuration's model, from the reference."""
    return ref_model.layout(ref_model.build(cfg, "cpu"))


def fresh_state(flat: torch.Tensor) -> TrainState:
    """The trainer's state before its first step: ``flat`` weights, zero
    moments."""
    return TrainState(step=0, params=flat, mu=torch.zeros_like(flat),
                      nu=torch.zeros_like(flat),
                      count=torch.zeros((), dtype=torch.int32,
                                        device=flat.device))


def build(cfg: Dict, seed: int, device
          ) -> Tuple[Trainer, List[ref_model.Leaf], torch.Tensor]:
    """(trainer, the layout, the initial flat weights): the weights are
    drawn on ``device`` from ``seed`` in the reference's layout, which has
    to be the trainer's."""
    trainer = Trainer(train_config(cfg, seed), device,
                      search_chunk=cfg["search_chunk"],
                      windowed=cfg["windowed"])
    leaves = reference_leaves(cfg)
    ours = [(lf.key, lf.size, lf.offset) for lf in leaves]
    theirs = [(lf.key, lf.size, lf.offset) for lf in trainer.layout]
    if ours != theirs:
        raise RuntimeError(f"{cfg['name']}: the program's parameter layout "
                           f"differs from the configuration's")
    return trainer, leaves, glorot_flat(leaves, seed, device)
