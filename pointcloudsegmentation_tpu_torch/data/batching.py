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
              rng: Optional[np.random.RandomState] = None,
              point_fields: Optional[Dict[str, np.ndarray]] = None) -> Dict:
    """Pad (or random-subsample) one block to exactly ``num_points``.

    Oversized blocks are subsampled (uniformly, like the reference's random
    resampling in default_unpack_feats_labels, provider.py:25-40); undersized
    blocks are zero-padded with mask=False.  ``point_fields``: extra
    per-point int arrays (e.g. context indices) that must ride the SAME
    subsample; zero-padded.
    """
    n = len(xyz)
    fdim = 0 if feats is None else feats.shape[1]
    point_fields = dict(point_fields or {})
    if n > num_points:
        rng = rng or np.random
        sel = rng.choice(n, num_points, replace=False)
        xyz = xyz[sel]
        feats = feats[sel] if feats is not None else None
        labels = labels[sel] if labels is not None else None
        point_fields = {k: v[sel] for k, v in point_fields.items()}
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
    out = {"xyz": out_xyz, "feats": out_feats, "labels": out_labels,
           "mask": mask}
    for k, v in point_fields.items():
        pv = np.zeros((num_points,), np.asarray(v).dtype)
        pv[:n] = v
        out[k] = pv
    return out


def pad_context(ctx_xyz: np.ndarray, ctx_feats: np.ndarray,
                ctx_idx: np.ndarray, cap: int,
                block_xyz: np.ndarray) -> Dict:
    """Pad a block's context sub-cloud to a static ``cap``.

    Unlike block points, context points are REFERENCED BY INDEX
    (ctx_idx), so an oversize cloud cannot be randomly subsampled: the cap
    keeps the ``cap`` context points nearest the block center (xy), the
    surviving indices are remapped, and block points whose context point
    was dropped are reassigned to their nearest kept context point (an
    exact argmin over the kept points: the function's own rule, not a
    fallback) -- exactly the degradation a 50 m crop would produce.
    """
    m = len(ctx_xyz)
    if m > cap:
        d = (ctx_xyz[:, 0] ** 2 + ctx_xyz[:, 1] ** 2)
        keep = np.argsort(d, kind="stable")[:cap]
        remap = np.full(m, -1, np.int64)
        remap[keep] = np.arange(cap)
        new_idx = remap[np.clip(ctx_idx, 0, m - 1)]
        bad = new_idx < 0
        if bad.any():
            kept_xyz = ctx_xyz[keep]
            d2 = ((block_xyz[bad][:, None, :] - kept_xyz[None, :, :]) ** 2
                  ).sum(-1)
            new_idx[bad] = d2.argmin(1)
        ctx_xyz, ctx_feats, ctx_idx = (ctx_xyz[keep], ctx_feats[keep],
                                       new_idx.astype(np.int32))
        m = cap
    out_xyz = np.zeros((cap, 3), np.float32)
    out_xyz[:m] = ctx_xyz
    out_feats = np.zeros((cap, ctx_feats.shape[1]), np.float32)
    out_feats[:m] = ctx_feats
    mask = np.zeros((cap,), bool)
    mask[:m] = True
    return {"ctx_xyz": out_xyz, "ctx_feats": out_feats, "ctx_mask": mask,
            "ctx_idx": np.asarray(ctx_idx, np.int32)}


def pad_fields(b: Dict, num_points: int, dense_num_points: int,
               ctx_num_points: int,
               rng: Optional[np.random.RandomState] = None) -> Dict:
    """One block dict padded to static shapes with every field it has:
    the block's points (``pad_block``, carrying ``ctx_idx`` through the
    subsample), the context cloud to ``ctx_num_points`` (``pad_context``)
    and the dense cloud to ``dense_num_points`` (``dense_mask``).  The rng
    draws come in the JAX Provider's order: the block's subsample, then the
    dense cloud's."""
    pb = pad_block(b["xyz"], b.get("feats"), b.get("labels"), num_points,
                   rng, point_fields={"ctx_idx": b["ctx_idx"]}
                   if "ctx_idx" in b else None)
    if "ctx_xyz" in b:
        pb.update(pad_context(b["ctx_xyz"], b["ctx_feats"],
                              pb.pop("ctx_idx"), ctx_num_points, pb["xyz"]))
    if "dense_xyz" in b:
        dp = pad_block(b["dense_xyz"], b["dense_feats"], None,
                       dense_num_points, rng)
        pb["dense_xyz"] = dp["xyz"]
        pb["dense_feats"] = dp["feats"]
        pb["dense_mask"] = dp["mask"]
    return pb


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
