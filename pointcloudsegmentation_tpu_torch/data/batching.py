"""Static-shape batching: pad variable-size blocks to a fixed point budget
and stack them into [B, ...] batches (the port's own copy of
``pointcloudsegmentation_tpu.data.batching``, numpy only, cut to what the
port calls: no per-point extra fields, no batch fill, no ``pad_context``).

The reference feeds variable-shape blocks one at a time; a static-shape
step needs each block padded (or subsampled) to ``num_points`` with an
explicit mask.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def pad_block(xyz: np.ndarray, feats: Optional[np.ndarray],
              labels: Optional[np.ndarray], num_points: int,
              rng: Optional[np.random.RandomState] = None) -> Dict:
    """Pad (or random-subsample) one block to exactly ``num_points``.

    Oversized blocks are subsampled uniformly; undersized blocks are
    zero-padded with mask=False.
    """
    n = len(xyz)
    fdim = 0 if feats is None else feats.shape[1]
    if n > num_points:
        rng = rng or np.random
        sel = rng.choice(n, num_points, replace=False)
        xyz = xyz[sel]
        feats = feats[sel] if feats is not None else None
        labels = labels[sel] if labels is not None else None
        n = num_points
    out_xyz = np.zeros((num_points, 3), np.float32)
    out_xyz[:n] = xyz
    out_feats = np.zeros((num_points, fdim), np.float32)
    if feats is not None:
        out_feats[:n] = feats
    out_labels = np.zeros((num_points,), np.int32)
    if labels is not None:
        out_labels[:n] = labels
    mask = np.zeros((num_points,), bool)
    mask[:n] = True
    return {"xyz": out_xyz, "feats": out_feats, "labels": out_labels,
            "mask": mask}


def stack_blocks(blocks: List[Dict]) -> Dict:
    """Stack padded blocks to a [B, ...] batch."""
    return {k: np.stack([b[k] for b in blocks]) for k in blocks[0]}
