"""Synthetic datasets for tests and benchmarks (the port's own copy of
``pointcloudsegmentation_tpu.data.toy``, numpy only): S3DIS-like room
blocks, the two-class toy cloud and the dense pipeline's batches.  The
same seed gives the same arrays as the JAX package's generators."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from .batching import pad_block, stack_blocks


def toy_two_class_block(rng: np.random.RandomState, n: int = 2048,
                        block: float = 3.0) -> Dict:
    """A plane (class 0) + a sphere cap (class 1), with rgb-ish features —
    separable only through neighborhood geometry."""
    n_plane = n // 2
    plane = rng.uniform(-block / 2, block / 2, (n_plane, 3)).astype(np.float32)
    plane[:, 2] = 0.02 * rng.randn(n_plane)
    theta = rng.uniform(0, 2 * np.pi, n - n_plane)
    phi = rng.uniform(0, np.pi / 2, n - n_plane)
    r = 0.8
    sphere = np.stack([r * np.sin(phi) * np.cos(theta),
                       r * np.sin(phi) * np.sin(theta),
                       r * np.cos(phi) + 0.2], 1).astype(np.float32)
    xyz = np.concatenate([plane, sphere], 0)
    labels = np.concatenate([np.zeros(n_plane, np.int32),
                             np.ones(n - n_plane, np.int32)])
    feats = rng.rand(n, 3).astype(np.float32) * 0.1  # uninformative colors
    perm = rng.permutation(n)
    return {"xyz": xyz[perm], "feats": feats[perm], "labels": labels[perm]}


def synthetic_room_block(rng: np.random.RandomState, n: int = 8192,
                         num_classes: int = 13, feat_dim: int = 12,
                         block: float = 3.0) -> Dict:
    """S3DIS-shaped random block: surface-structured points whose labels
    correlate with geometry+features, for throughput benchmarking and
    training smoke tests."""
    n_floor, n_wall = n // 3, n // 3
    n_rest = n - n_floor - n_wall
    floor = rng.uniform(-block / 2, block / 2, (n_floor, 3))
    floor[:, 2] = 0.02 * rng.randn(n_floor)
    wall = rng.uniform(-block / 2, block / 2, (n_wall, 3))
    wall[:, 0] = block / 2 - 0.05 + 0.02 * rng.randn(n_wall)
    rest = rng.uniform(-block / 2, block / 2, (n_rest, 3))
    xyz = np.concatenate([floor, wall, rest], 0).astype(np.float32)
    feats = rng.rand(n, feat_dim).astype(np.float32) * 2 - 1
    region = (np.floor((xyz[:, 0] + block / 2)) * 3
              + np.floor(xyz[:, 2] + 1.0)).astype(np.int32)
    feat_bit = (feats[:, 0] > 0) if feat_dim > 0 else 0
    labels = (region + feat_bit) % num_classes
    perm = rng.permutation(n)
    return {"xyz": xyz[perm], "feats": feats[perm],
            "labels": labels[perm].astype(np.int32)}


def dense_batches(num_batches: int, batch_size: int, num_points: int = 512,
                  dense_factor: int = 4, seed: int = 0,
                  num_classes: int = 9, feat_dim: int = 13
                  ) -> Iterator[Dict]:
    """Synthetic dense-pipeline batches: a dense room block of
    ``dense_factor * num_points`` points and a random subset of
    ``num_points`` that carries the labels (``dense_xyz``,
    ``dense_feats``, ``dense_mask`` beside the sampled fields), as the
    dense trainer feeds them (train_gpn_semantic3d_dense.py:52-65)."""
    rng = np.random.RandomState(seed)
    nd = num_points * dense_factor
    for _ in range(num_batches):
        blocks = []
        for _ in range(batch_size):
            d = synthetic_room_block(rng, nd, num_classes, feat_dim)
            sel = rng.choice(nd, num_points, replace=False)
            b = pad_block(d["xyz"][sel], d["feats"][sel], d["labels"][sel],
                          num_points, rng)
            dense = pad_block(d["xyz"], d["feats"], None, nd, rng)
            b["dense_xyz"] = dense["xyz"]
            b["dense_feats"] = dense["feats"]
            b["dense_mask"] = dense["mask"]
            blocks.append(b)
        yield stack_blocks(blocks)


def toy_batches(num_batches: int, batch_size: int, num_points: int = 2048,
                seed: int = 0, kind: str = "toy", num_classes: int = 13,
                feat_dim: int = 12) -> Iterator[Dict]:
    """``num_batches`` batches of ``batch_size`` padded blocks: two-class
    toy clouds (``kind="toy"``, the default as in JAX; 3 features, labels
    0 and 1) or room blocks (``kind="room"``, which every caller that
    trains a model passes)."""
    if kind not in ("room", "toy"):
        raise ValueError(f"kind must be room or toy: {kind}")
    rng = np.random.RandomState(seed)
    gen = (toy_two_class_block if kind == "toy" else
           lambda r, n: synthetic_room_block(r, n, num_classes, feat_dim))
    for _ in range(num_batches):
        blocks = []
        for _ in range(batch_size):
            b = gen(rng, num_points)
            blocks.append(pad_block(b["xyz"], b["feats"], b["labels"],
                                    num_points, rng))
        yield stack_blocks(blocks)
