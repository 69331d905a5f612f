"""ModelNet40 classification inputs (the port's own copy of
``pointcloudsegmentation_tpu.data.modelnet``, numpy only; the same inputs
and seeds give the same arrays).  The reference's io_util.py:197-207,
aug_util.py:467-517, data_util.py:614-638 and train_modelnet40.py.

1024-point unit-normalised clouds, one label per cloud; the features are
the 9 local covariance descriptors.  A batch carries each cloud's label on
every point (the trainer's classification branch reads ``labels[b][0]``)
in the static block layout of segmentation.
"""
from __future__ import annotations

import pickle
from typing import Dict, List, Optional

import numpy as np

from . import augment

NUM_CLASSES = 40


def normalize_cloud(xyz: np.ndarray) -> np.ndarray:
    """Center + scale into the unit sphere."""
    xyz = xyz - xyz.mean(0, keepdims=True)
    scale = np.sqrt((xyz ** 2).sum(1)).max()
    return (xyz / max(scale, 1e-6)).astype(np.float32)


def prepare_cloud(xyz: np.ndarray, label: int,
                  covar_radius: float = 0.15,
                  rng: Optional[np.random.RandomState] = None,
                  augment_geometry: bool = False) -> Dict:
    """One cloud -> {xyz, feats (9 covariance columns), labels (the label
    on every point)}; with ``augment_geometry`` a random x flip, z rotation
    and per-axis scale first."""
    rng = rng or np.random.RandomState()
    xyz = normalize_cloud(xyz)
    if augment_geometry:
        if rng.rand() < 0.5:
            xyz = augment.flip(xyz, 0)
        xyz = augment.rotate_z(xyz, rng.rand() * 2 * np.pi)
        xyz = xyz * rng.uniform(0.9, 1.1, (1, 3)).astype(np.float32)
    covars = augment.compute_covars(xyz, covar_radius,
                                    np.arange(len(xyz), dtype=np.int32))
    return {"xyz": xyz.astype(np.float32), "feats": covars,
            "labels": np.full(len(xyz), label, np.int32)}


def clouds_from_pkl(model: str, filename: str,
                    rng: Optional[np.random.RandomState] = None
                    ) -> List[Dict]:
    """Provider read_fn for prepared ModelNet pkls (a list of (xyz, label)
    pairs); train clouds are augmented."""
    rng = rng or np.random.RandomState()
    with open(filename, "rb") as f:
        items = pickle.load(f)
    return [prepare_cloud(x, int(l), rng=rng,
                          augment_geometry=(model == "train"))
            for x, l in items]
