"""Dataset IO: pkl/h5 room readers and split lists (reference:
io_util.py:10-121); the port's own copy of
``pointcloudsegmentation_tpu.data.io_util``.  ``read_room_h5`` imports h5py
only when called."""
from __future__ import annotations

import os
import pickle
from typing import List, Optional, Sequence, Tuple

import numpy as np


def read_pkl(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def save_pkl(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)


def read_room_pkl(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Room pkl -> (points [n,6] xyz+rgb, labels [n]) (io_util.get_block_points
    semantics)."""
    data = read_pkl(path)
    if isinstance(data, dict):
        return np.asarray(data["points"]), np.asarray(data["labels"])
    points, labels = data[0], data[1]
    return np.asarray(points), np.asarray(labels).reshape(-1)


def save_room_pkl(path: str, points: np.ndarray, labels: np.ndarray) -> None:
    save_pkl(path, (np.asarray(points, np.float32),
                    np.asarray(labels, np.int32)))


def read_room_h5(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """H5 room reader (io_util.read_room_h5; gated on h5py availability)."""
    try:
        import h5py
    except ImportError as e:  # pragma: no cover
        raise ImportError("h5py not available in this image; "
                          "use pkl rooms instead") from e
    with h5py.File(path, "r") as f:
        return np.asarray(f["data"]), np.asarray(f["label"]).reshape(-1)


def get_train_test_split(stems: Sequence[str], test_area: int = 5
                         ) -> Tuple[List[str], List[str]]:
    """Area-N holdout (io_util.get_block_train_test_split)."""
    train = [s for s in stems if f"Area_{test_area}" not in s]
    test = [s for s in stems if f"Area_{test_area}" in s]
    return train, test


def read_stems(path: str) -> List[str]:
    """Room stem list file (cached/room_block*_stems.txt pattern)."""
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def depth_to_points(depth: np.ndarray, fx: float, fy: float,
                    cx: Optional[float] = None, cy: Optional[float] = None
                    ) -> np.ndarray:
    """Depth map -> point cloud (the reference's NYU experiment,
    nyu_data_util.py:6-33)."""
    h, w = depth.shape
    cx = w / 2.0 if cx is None else cx
    cy = h / 2.0 if cy is None else cy
    v, u = np.mgrid[0:h, 0:w].astype(np.float32)
    z = depth.astype(np.float32)
    x = (u - cx) * z / fx
    y = (v - cy) * z / fy
    pts = np.stack([x, y, z], -1).reshape(-1, 3)
    return pts[pts[:, 2] > 0]
