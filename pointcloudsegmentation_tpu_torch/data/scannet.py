"""ScanNet dataset pipeline, the port's own copy of
``pointcloudsegmentation_tpu.data.scannet`` (reference:
scannet_data_util.py:19-179, aug_util.py:518-636,
train_gpn_scannet_new.py).

ScanNet blocks carry no color; the model input is geometry only (the ScanNet
encoder's first conv is xyz-only, model_pointnet.py:1440-1446).  Label 0 =
unannotated and is masked from the loss with remaining labels shifted by -1
(train_gpn_scannet_new.py:81-88) — handled by the trainer's
``ignore_label=0`` config, so blocks keep raw 0..20 labels here.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from . import augment
from .io_util import read_pkl

NUM_CLASSES = 20  # after shifting out label 0

# per-class training weights (cached/scannet_weights.txt pattern); computed
# from label frequencies when preparing data
DEFAULT_WEIGHTS = None


def prepare_scene(xyz: np.ndarray, labels: np.ndarray,
                  ds_stride: float = 0.05, block_size: float = 3.0,
                  block_stride: float = 1.5, min_pn: int = 512,
                  rng: Optional[np.random.RandomState] = None,
                  augment_geometry: bool = False) -> Dict:
    """One scene -> cropped, normalized blocks (no-RGB variant of
    aug_util.py:518-636)."""
    pts = np.concatenate([xyz, np.zeros_like(xyz)], 1).astype(np.float32)
    xyzs, _, covars, lbls = augment.sample_block(
        pts, labels, ds_stride, block_size, block_stride, min_pn, rng=rng,
        use_rescale=augment_geometry, use_flip=augment_geometry,
        use_rotate=augment_geometry)
    block_mins = []
    out_xyz = []
    for x in xyzs:
        mn = x.min(0, keepdims=True).copy()
        mn[:, :2] += block_size / 2.0
        out_xyz.append((x - mn).astype(np.float32))
        block_mins.append(mn[0])
    return {"xyzs": out_xyz, "covars": covars,
            "lbls": [l.astype(np.int32) for l in lbls],
            "block_mins": block_mins}


def blocks_from_scene_pkl(model: str, filename: str,
                          rng: Optional[np.random.RandomState] = None
                          ) -> List[Dict]:
    """Provider read_fn: geometry-only features (empty feat vector; the
    ScanNet encoder ignores input feats)."""
    return blocks_from_scene(model, read_pkl(filename), rng)


def blocks_from_scene(model: str, data: Dict,
                      rng: Optional[np.random.RandomState] = None
                      ) -> List[Dict]:
    """``blocks_from_scene_pkl`` on a scene pkl already loaded."""
    rng = rng or np.random.RandomState()
    xyzs, lbls = data["xyzs"], data["lbls"]
    out = []
    for i in range(len(xyzs)):
        xyz = xyzs[i]
        if model == "train":
            if rng.rand() < 0.5:
                xyz = augment.flip(xyz, 0)
            if rng.rand() < 0.5:
                xyz = augment.flip(xyz, 1)
            if rng.rand() < 0.5:
                xyz = augment.swap_xy(xyz)
        out.append({"xyz": xyz.astype(np.float32),
                    "feats": np.zeros((len(xyz), 1), np.float32),
                    "labels": np.asarray(lbls[i], np.int32).reshape(-1)})
    return out


def class_weights_from_counts(counts: np.ndarray) -> np.ndarray:
    """Inverse-log-frequency weights (the pattern behind
    cached/scannet_weights.txt): w_c = 1 / ln(1.2 + n_c / N)."""
    freq = counts / max(counts.sum(), 1)
    return (1.0 / np.log(1.2 + freq)).astype(np.float32)
