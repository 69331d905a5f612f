"""S3DIS dataset pipeline (the port's own copy of
``pointcloudsegmentation_tpu.data.s3dis``).

Mirrors the reference's offline prep + online read path:

- offline: rooms (``[n,6]`` xyz+rgb + labels pkls) -> ``sample_block`` ->
  ``normalize_block`` -> per-room sampled pkls (s3dis_util.py:140-241,
  written to data/S3DIS/sampled_train*/).
- online: ``read_fn`` loads a sampled pkl and applies the reduced train-time
  augmentation — flips/swap + color jitter (train_graph_pool_new.py:246-275).
- Area-5 train/test split from room stem lists (io_util.py:64-103).

13 classes: ceiling floor wall beam column window door table chair sofa
bookcase board clutter (cached/class_names.txt).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from . import augment
from .io_util import read_pkl, save_pkl  # noqa: F401  (s3dis.save_pkl)

CLASS_NAMES = ("ceiling", "floor", "wall", "beam", "column", "window",
               "door", "table", "chair", "sofa", "bookcase", "board",
               "clutter")
NUM_CLASSES = 13


def train_test_split(stem_file: str,
                     test_area: int = 5) -> Tuple[List[str], List[str]]:
    """Area-N holdout from a room-stem list (io_util.py:64-103)."""
    with open(stem_file) as f:
        stems = [ln.strip() for ln in f if ln.strip()]
    train = [s for s in stems if f"Area_{test_area}" not in s]
    test = [s for s in stems if f"Area_{test_area}" in s]
    return train, test


def prepare_room(points: np.ndarray, labels: np.ndarray,
                 ds_stride: float = 0.05, block_size: float = 3.0,
                 block_stride: float = 1.5, min_pn: int = 512,
                 rng: Optional[np.random.RandomState] = None,
                 augment_geometry: bool = False) -> Dict:
    """One room -> sampled/normalized blocks (the offline prep of
    s3dis_util.prepare_* + normalize_block)."""
    xyzs, rgbs, covars, lbls = augment.sample_block(
        points, labels, ds_stride, block_size, block_stride, min_pn,
        rng=rng, use_rescale=augment_geometry, use_flip=augment_geometry,
        use_rotate=augment_geometry)
    xyzs, rgbs, lbls, block_mins = augment.normalize_block(
        xyzs, rgbs, lbls, bsize=block_size)
    return {"xyzs": xyzs, "rgbs": rgbs, "covars": covars, "lbls": lbls,
            "block_mins": block_mins}


def blocks_from_room_pkl(model: str, filename: str,
                         use_covars: bool = False,
                         rng: Optional[np.random.RandomState] = None
                         ) -> List[Dict]:
    """Provider read_fn for pre-sampled room pkls
    (train_graph_pool_new.py:248-275): train mode applies flips/swap +
    color jitter; features are rgb (optionally ‖ covars)."""
    return blocks_from_room(model, read_pkl(filename), use_covars, rng)


def blocks_from_room(model: str, data, use_covars: bool = False,
                     rng: Optional[np.random.RandomState] = None
                     ) -> List[Dict]:
    """``blocks_from_room_pkl`` on a room pkl already loaded."""
    rng = rng or np.random.RandomState()
    if isinstance(data, dict):
        xyzs, rgbs, covars, lbls = (data["xyzs"], data["rgbs"],
                                    data["covars"], data["lbls"])
    else:  # reference tuple layout (xyzs, rgbs, covars, lbls, block_mins)
        xyzs, rgbs, covars, lbls = data[0], data[1], data[2], data[3]
    out = []
    for i in range(len(xyzs)):
        xyz, rgb = xyzs[i], rgbs[i]
        if model == "train":
            xyz, rgb = augment.train_time_augment(xyz, rgb, rng)
        feats = (np.concatenate([rgb, covars[i]], 1).astype(np.float32)
                 if use_covars else rgb.astype(np.float32))
        out.append({"xyz": xyz.astype(np.float32), "feats": feats,
                    "labels": np.asarray(lbls[i], np.int32).reshape(-1)})
    return out
