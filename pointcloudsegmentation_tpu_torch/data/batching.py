"""Static-shape batching: pad variable-size blocks to a fixed point budget
and stack them into [B, ...] device batches (the port's own copy of
``pointcloudsegmentation_tpu.data.batching``, numpy only).

The reference feeds variable-shape blocks through tf.placeholders (one block
per GPU, train_gpn_scannet_new.py:243-252); XLA needs static shapes, so each
block is padded (or subsampled) to ``num_points`` with an explicit mask;
a static-shape step needs the same.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def pad_block(xyz: np.ndarray, feats: Optional[np.ndarray],
              labels: Optional[np.ndarray], num_points: int,
              rng: Optional[np.random.RandomState] = None) -> Dict:
    """Pad (or random-subsample) one block to exactly ``num_points``.

    Oversized blocks are subsampled (uniformly, like the reference's random
    resampling in default_unpack_feats_labels, provider.py:25-40); undersized
    blocks are zero-padded with mask=False.  The JAX package's
    ``point_fields`` and ``pad_context`` come with the context read_fns
    that use them (ROADMAP M13).
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


def stack_blocks(blocks: List[Dict], batch_size: Optional[int] = None,
                 rng: Optional[np.random.RandomState] = None,
                 pad_masked: bool = False) -> Dict:
    """Stack padded blocks to a [B, ...] batch; if ``batch_size`` is given and
    larger, fill with either re-sampled random blocks (train — the reference
    pads the batch to a multiple of num_gpus the same way, provider.py:25-40)
    or, with ``pad_masked=True`` (eval), fully-masked zero blocks so padding
    never double-counts points in loss/IoU (fixes the reference's wart of
    duplicating random test blocks)."""
    if batch_size is not None and len(blocks) < batch_size:
        if pad_masked:
            zero = {k: np.zeros_like(v) for k, v in blocks[0].items()}
            extra = [zero] * (batch_size - len(blocks))
        else:
            rng = rng or np.random
            extra = [blocks[rng.randint(len(blocks))]
                     for _ in range(batch_size - len(blocks))]
        blocks = list(blocks) + extra
    keys = blocks[0].keys()
    return {k: np.stack([b[k] for b in blocks]) for k in keys}
