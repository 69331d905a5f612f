"""Anchor ("pmiu") directions of the Gaussian-anchored convolutions (the
port's own copy of ``pointcloudsegmentation_tpu.ops.anchors``, numpy only;
the same arguments give the same arrays bit for bit):

- ``sphere_kmeans_anchors``: a seeded k-means of m centers on the unit
  sphere, rotated so that anchor 0 points at +z (the reference's
  tf_ops/generate_pmiu.py:11-51);
- ``grid_anchors_v2``: the 26-anchor lat/long grid plus both poles
  (train_graph_pool.py:254-266); ``grid_anchors``: the full 40-anchor grid
  (:269-279).

The k-means costs about a second at m = 26, so ``cached_sphere_anchors``
keeps one result per m for the modules that build their anchors at
construction.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np


def sphere_kmeans_anchors(m: int, seed: int = 0, iters: int = 50,
                          samples: int = 20000) -> np.ndarray:
    """K-means of ``m`` anchor directions on the unit sphere, canonicalized.

    Returns [3, m] float32 (the reference's pmiu layout, anchors as columns).
    """
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-1.0, 1.0, (samples, 3))
    pts /= np.sqrt(np.sum(pts ** 2, axis=1, keepdims=True) + 1e-6)
    centers = pts[rng.choice(samples, m, replace=False)]
    for _ in range(iters):
        d2 = ((pts[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        assign = d2.argmin(1)
        for i in range(m):
            sel = pts[assign == i]
            if len(sel):
                centers[i] = sel.mean(0)
    centers = _canonicalize(centers)
    return centers.T.astype(np.float32)


@lru_cache(maxsize=None)
def _cached(m: int) -> np.ndarray:
    out = sphere_kmeans_anchors(m)
    out.setflags(write=False)
    return out


def cached_sphere_anchors(m: int) -> np.ndarray:
    """``sphere_kmeans_anchors(m)`` with the default seed and sizes,
    computed once per m; a writable copy."""
    return _cached(m).copy()


def _canonicalize(centers: np.ndarray) -> np.ndarray:
    """Rotate so anchor 0 lands on +z (two Givens rotations, matching
    tf_ops/generate_pmiu.py:36-48)."""
    ang1 = -np.arctan2(centers[0, 0], centers[0, 1])
    c, s = np.cos(ang1), np.sin(ang1)
    m1 = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)
    centers = centers @ m1
    ang2 = -(np.pi / 2 - np.arctan2(centers[0, 2], centers[0, 1]))
    c, s = np.cos(ang2), np.sin(ang2)
    m2 = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float64)
    return centers @ m2


def grid_anchors_v2() -> np.ndarray:
    """Analytic 26-anchor lat/long grid + poles
    (train_graph_pool.py:254-266).  Returns [3, 26] float32."""
    interval = 2 * np.pi / 8
    pmiu = []
    for va in np.arange(-np.pi / 2 + interval, np.pi / 2, interval):
        for ha in np.arange(0, 2 * np.pi, interval):
            pmiu.append([np.cos(va) * np.cos(ha),
                         np.cos(va) * np.sin(ha),
                         np.sin(va)])
    pmiu.append([0.0, 0.0, 1.0])
    pmiu.append([0.0, 0.0, -1.0])
    return np.asarray(pmiu, np.float32).T


def grid_anchors() -> np.ndarray:
    """Full lat/long grid including both pole rings
    (train_graph_pool.py:269-279).  Returns [3, 40] float32."""
    interval = 2 * np.pi / 8
    pmiu = []
    for va in np.arange(-np.pi / 2, np.pi / 2 + interval, interval):
        for ha in np.arange(0, 2 * np.pi, interval):
            pmiu.append([np.cos(va) * np.cos(ha),
                         np.cos(va) * np.sin(ha),
                         np.sin(va)])
    return np.asarray(pmiu, np.float32).T
