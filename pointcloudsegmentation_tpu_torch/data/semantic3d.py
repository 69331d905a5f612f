"""Semantic3D dataset pipeline, the port's own copy of the training part of
``pointcloudsegmentation_tpu.data.semantic3d`` (reference:
data_util.py:50-80, semantic3d_util.py:136-295,
semantic3d_context_util.py:110-153, 322-333, 578-583,
semantic3d_dense_util.py:10-97).

Raw ``.txt`` scans (x y z intensity r g b + ``.labels``) -> macro blocks
(80 m at a 0.03 m grid downsample) -> 10 m training blocks with rotation
augmentation -> per-scan block pkls (``save_blocks``) -> the train-time read
(``blocks_from_list``: flips and color jitter).  The dense pipeline reads
the same pkls with a grid-downsampled subset beside each block's dense
cloud (``dense_blocks_from_list``); the context pipeline pairs each block
with its 50 m context cloud and per-point context indices
(``prepare_context_scene``, read by ``context_blocks_from_list``).  Labels
stay raw: 0 = unlabeled, 1..8 the 8 classes; the port's
``semantic3d_config`` ignores label 0 and shifts the rest by -1
(ROADMAP.md §3).

Test scans go another way (``presample_test_blocks``,
``process_test_blocks``, ``save_eval_scene``): 50 m macro blocks at a
0.03 m downsample, cut without augmentation into 10 m eval blocks at a
2.5 m stride, optionally after a z-rotation of the whole scan (the
rotation ensemble's arms), written as one columnar scene pkl per scan and
arm that the scene eval reads back with ``eval_scene_blocks``.  The
per-scan z-offset map (``write_offset_z_map``) is written by the prep and
read by nothing."""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import augment, native
from .io_util import save_pkl

NUM_CLASSES = 8  # man-made terrain .. cars (class 0 = unlabeled, ignored)
ROT_STEP = np.pi / 12.0  # the angle between two arms of the rotation ensemble


def read_points_txt(path: str, labels_path: Optional[str] = None
                    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """A Semantic3D .txt scan (x y z i r g b per line) as float32 [n, 7],
    and its .labels file as int32 [n] where it exists
    (read_semantic3d_points_file, data_util.py:50-80)."""
    with open(path) as f:
        pts = np.loadtxt(f, dtype=np.float32, ndmin=2)
    labels = None
    if labels_path and os.path.exists(labels_path):
        labels = np.loadtxt(labels_path, dtype=np.int32)
    return pts, labels


def write_points_txt(path: str, points: np.ndarray,
                     labels: Optional[np.ndarray] = None) -> None:
    """Write a scan in Semantic3D's raw layout, the inverse of
    ``read_points_txt``: x y z in mm-rounded metres, then intensity and
    r g b as integers, one point per line; with ``labels`` also the
    ``.labels`` file beside it, one label per line."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savetxt(path, points, fmt="%.3f %.3f %.3f %d %d %d %d")
    if labels is not None:
        np.savetxt(os.path.splitext(path)[0] + ".labels", labels, fmt="%d")


def to_big_blocks(points: np.ndarray, labels: Optional[np.ndarray],
                  block_size: float = 80.0, ds_stride: float = 0.03
                  ) -> List[Dict]:
    """Partition a scan into macro blocks with grid downsample
    (semantic3d_to_block, semantic3d_util.py:136-178)."""
    xyz = points[:, :3]
    mins = xyz.min(0)
    bx = np.floor((xyz[:, 0] - mins[0]) / block_size).astype(np.int64)
    by = np.floor((xyz[:, 1] - mins[1]) / block_size).astype(np.int64)
    key = bx * 10000 + by
    out = []
    for k in np.unique(key):
        sel = np.nonzero(key == k)[0]
        sub = points[sel]
        keep = augment.grid_downsample(sub[:, :3], ds_stride)
        blk = {"points": sub[keep]}
        if labels is not None:
            blk["labels"] = labels[sel][keep]
        out.append(blk)
    return out


def sample_training_blocks(points: np.ndarray, labels: np.ndarray,
                           block_size: float = 10.0, stride: float = 5.0,
                           ds_stride: float = 0.06, min_pn: int = 1024,
                           rng: Optional[np.random.RandomState] = None,
                           rotate: bool = True,
                           covar_nn_size: float = 0.3) -> List[Dict]:
    """10 m training blocks with optional rotation augmentation
    (semantic3d_sample_single_file_training_block,
    semantic3d_util.py:279-295).  Features: rgb + intensity + covars."""
    rng = rng or np.random.RandomState()
    xyz = np.ascontiguousarray(points[:, :3], np.float32)
    intensity = points[:, 3:4].astype(np.float32)
    rgb = points[:, 4:7].astype(np.float32)

    if rotate and rng.rand() > 0.3:
        xyz = augment.rotate_z(xyz, rng.rand() * np.pi / 2.0)

    ds_idx = augment.grid_downsample(xyz, ds_stride)
    covars = augment.compute_covars(xyz, covar_nn_size, ds_idx)
    xyz_s, rgb_s = xyz[ds_idx], rgb[ds_idx]
    int_s, lbl_s = intensity[ds_idx], labels[ds_idx]

    rel = xyz_s - xyz_s.min(0, keepdims=True)
    crops = augment.uniform_sample_block(rel, block_size, stride,
                                         min_pn=min_pn)
    blocks = []
    for c in crops:
        x = xyz_s[c]
        mn = x.min(0, keepdims=True).copy()
        mn[:, :2] += block_size / 2.0
        # intensity standardized, rgb to [-1,1]
        # (normalize_block_hierarchy, aug_util.py:425-450)
        it = int_s[c]
        it = (it - it.mean()) / (it.std() + 1e-6)
        feats = np.concatenate(
            [rgb_s[c] / 127.5 - 1.0, it, covars[c]], 1).astype(np.float32)
        blocks.append({"xyz": (x - mn).astype(np.float32), "feats": feats,
                       "labels": lbl_s[c].astype(np.int32),
                       "block_min": mn[0].astype(np.float32)})
    return blocks


def compute_offset_z(points: np.ndarray, bin_size: float = 0.1,
                     z_range: float = 20.0) -> float:
    """Dominant ground-plane height of a scan: the mode of the z histogram
    (0.1 m bins over 20 m) plus the minimum z
    (semantic3d_sample_trainset_offset_z, semantic3d_util.py:10-55)."""
    zs = points[:, 2].astype(np.float64)
    min_z = zs.min()
    hist, _ = np.histogram(zs - min_z, np.arange(0.0, z_range, bin_size))
    return float(np.argmax(hist) * bin_size + min_z)


def write_offset_z_map(path: str, stem_points) -> Dict[str, float]:
    """Write the per-scan z-offset map, one ``stem offset`` line per scan
    (cached/semantic3d_train_offsetz.txt, semantic3d_util.py:18-46).
    ``stem_points``: iterable of (stem, points [n, >=3])."""
    out = {}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for stem, pts in stem_points:
            off = compute_offset_z(np.asarray(pts))
            out[stem] = off
            f.write(f"{stem} {off}\n")
    return out


def read_offset_z_map(path: str) -> Dict[str, float]:
    """semantic3d_read_map_offset_z (semantic3d_util.py:49-58)."""
    out = {}
    with open(path) as f:
        for line in f:
            stem, off = line.strip().split(" ")
            out[stem] = float(off)
    return out


def presample_test_blocks(points: np.ndarray,
                          block_size: float = 50.0, stride: float = 45.0,
                          ds_stride: float = 0.03, min_pn: int = 128
                          ) -> List[np.ndarray]:
    """Test-set presample: overlapping 50 m macro blocks of the scan at a
    0.03 m downsample, no augmentation
    (semantic3d_testset_presample_block, semantic3d_util.py:466-481).
    Returns [n, 7] point arrays (x y z i r g b, absolute coordinates)."""
    xyz = np.ascontiguousarray(points[:, :3], np.float32)
    keep = augment.grid_downsample(xyz, ds_stride)
    pts = points[keep]
    rel = pts[:, :3] - pts[:, :3].min(0, keepdims=True)
    crops = augment.uniform_sample_block(rel, block_size, stride,
                                         min_pn=min_pn)
    return [pts[c] for c in crops]


def process_test_blocks(points: np.ndarray, rot_ang: float = 0.0,
                        block_size: float = 10.0, stride: float = 2.5,
                        ds_stride: float = 0.06,
                        covar_nn_size: float = 0.3,
                        min_pn: int = 128) -> List[Dict]:
    """Deterministic 10 m eval blocks of one presampled macro block, after
    an optional z-rotation of its absolute coordinates by ``rot_ang`` (the
    rotation ensemble's arms, k·pi/12;
    semantic3d_process_test_block[_with_rotate], semantic3d_util.py:
    483-557).  No flips, rescale or jitter; labels are zeros; each block's
    ``block_min`` places it in the (rotated) absolute frame."""
    pts = np.asarray(points, np.float32)
    if rot_ang != 0.0:
        pts = pts.copy()
        pts[:, :3] = augment.rotate_z(
            np.ascontiguousarray(pts[:, :3]), rot_ang)
    return sample_training_blocks(pts, np.zeros(len(pts), np.int32),
                                  block_size=block_size, stride=stride,
                                  ds_stride=ds_stride, min_pn=min_pn,
                                  rng=np.random.RandomState(0),
                                  rotate=False,
                                  covar_nn_size=covar_nn_size)


def save_eval_scene(path: str, blocks: List[Dict], ctx_cloud: np.ndarray,
                    scan_xyz: Optional[np.ndarray] = None,
                    scan_labels: Optional[np.ndarray] = None) -> None:
    """Write one scan's eval scene for one rotation arm: a pkl of a dict
    of columns, the JAX package's four (the reference's ``test_block_avg``
    layout, interpolate_semantic3d_new.py:68-90) and the port's
    ``ctx_cloud``; arm 0 (the unrotated arm, ``scan_xyz`` given) also holds
    the scan's own points and labels, once per scan:

    - ``xyzs``: per block, its points [n, 3] float32 relative to its min;
    - ``rgbs``: per block, its features [n, 4 + 9] float32 (rgb in
      [-1, 1], standardised intensity, covariances), under the JAX name;
    - ``lbls``: per block, int32 [n] zeros (test blocks carry no labels);
    - ``block_mins``: per block, float32 [3], its place in the arm's
      rotated absolute frame;
    - ``ctx_cloud``: [m, 7] float32, ``context_cloud`` (5 m) of the whole
      scan rotated by the arm's angle, in the arm's absolute frame: the
      context model's 50 m windows are cut from it per block
      (``eval_scene_blocks``);
    - arm 0 only, ``scan_xyz``: the scan's full-resolution xyz [N, 3]
      float32, in file order, in the original frame: the points a
      submission labels;
    - arm 0 only, ``scan_labels``: int32 [N], the scan's ``.labels`` where
      the file exists, else zeros (unlabeled: nothing is scored)."""
    data = {"xyzs": [b["xyz"] for b in blocks],
            "rgbs": [b["feats"] for b in blocks],
            "lbls": [b["labels"] for b in blocks],
            "block_mins": [b["block_min"] for b in blocks],
            "ctx_cloud": np.asarray(ctx_cloud, np.float32)}
    if scan_xyz is not None:
        data["scan_xyz"] = np.ascontiguousarray(scan_xyz, np.float32)
        data["scan_labels"] = np.asarray(scan_labels, np.int32)
    save_pkl(path, data)


def eval_scene_blocks(data: Dict, context: bool = False,
                      ctx_block: float = 50.0) -> List[Dict]:
    """A loaded ``save_eval_scene`` pkl -> block dicts (xyz, feats,
    labels, block_min) in the layout of ``save_blocks``, for a model's
    read of prepared blocks; with ``context``, each block also gets its
    window of the scene's ``ctx_cloud`` as ``prepare_context_scene`` cuts
    it (``context_window``)."""
    blocks = [{"xyz": x, "feats": f, "labels": l,
               "block_min": np.asarray(m, np.float32)}
              for x, f, l, m in zip(data["xyzs"], data["rgbs"], data["lbls"],
                                    data["block_mins"])]
    if context:
        ctx_abs, ctx_feats = context_features(data["ctx_cloud"])
        for b in blocks:
            b["ctx_xyz"], b["ctx_feats"], b["ctx_idx"] = context_window(
                b["xyz"], b["block_min"], ctx_abs, ctx_feats, ctx_block)
    return blocks


def save_blocks(path: str, blocks: List[Dict]) -> None:
    save_pkl(path, blocks)


def blocks_from_list(model: str, blocks: List[Dict],
                     rng: Optional[np.random.RandomState] = None
                     ) -> List[Dict]:
    """The read of a block pkl already loaded (the JAX
    ``blocks_from_pkl``, semantic3d.py:339-358): train mode flips x and y
    each with probability 1/2 and jitters the colors by up to 0.02."""
    rng = rng or np.random.RandomState()
    out = []
    for b in blocks:
        xyz, feats = b["xyz"], b["feats"]
        if model == "train":
            if rng.rand() < 0.5:
                xyz = augment.flip(xyz, 0)
            if rng.rand() < 0.5:
                xyz = augment.flip(xyz, 1)
            feats = feats.copy()
            feats[:, :3] += rng.uniform(-0.02, 0.02, (len(feats), 3))
        out.append({"xyz": xyz.astype(np.float32),
                    "feats": feats.astype(np.float32),
                    "labels": b["labels"].astype(np.int32)})
    return out


def dense_blocks_from_list(model: str, blocks: List[Dict],
                           sample_stride: float = 0.25,
                           rng: Optional[np.random.RandomState] = None
                           ) -> List[Dict]:
    """The dense pipeline's read of a block pkl already loaded (the JAX
    ``dense_blocks_from_pkl``, semantic3d.py:319-336): each block read as
    ``blocks_from_list`` reads it is the DENSE cloud (``dense_xyz``,
    ``dense_feats``), and its ``sample_stride`` grid-downsampled subset
    carries the labels through the pyramid; the model joins the two on
    the device (``models.dense.DenseFeats``)."""
    out = []
    for b in blocks_from_list(model, blocks, rng):
        keep = augment.grid_downsample(b["xyz"], sample_stride)
        out.append({"xyz": b["xyz"][keep], "feats": b["feats"][keep],
                    "labels": b["labels"][keep],
                    "dense_xyz": b["xyz"], "dense_feats": b["feats"]})
    return out


def context_cloud(points: np.ndarray, ds_size: float = 5.0) -> np.ndarray:
    """Global average-downsampled context cloud (global_avg_downsample,
    semantic3d_context_util.py:110-153): mean xyz+feats per 5 m voxel."""
    xyz = points[:, :3]
    mins = xyz.min(0, keepdims=True)
    coords = np.floor((xyz - mins) / ds_size).astype(np.int64)
    dims = coords.max(0) + 1
    key = (coords[:, 0] * dims[1] + coords[:, 1]) * dims[2] + coords[:, 2]
    order = np.argsort(key, kind="stable")
    skey = key[order]
    boundaries = np.concatenate([[0], np.nonzero(np.diff(skey))[0] + 1,
                                 [len(skey)]])
    out = np.empty((len(boundaries) - 1, points.shape[1]), np.float32)
    for vi in range(len(boundaries) - 1):
        seg = order[boundaries[vi]:boundaries[vi + 1]]
        out[vi] = points[seg].mean(0)
    return out


def context_indices(block_xyz: np.ndarray, ctx_xyz: np.ndarray
                    ) -> np.ndarray:
    """Nearest context point per block point (compute_context_idxs,
    semantic3d_context_util.py:322-333), by the native k-NN; a native
    library that does not build raises (no dense argmin in its place)."""
    idx, _ = native.knn(ctx_xyz, block_xyz, 1, cell_hint=5.0)
    return idx[:, 0].astype(np.int32)


def prepare_context_scene(points: np.ndarray, labels: np.ndarray,
                          block_size: float = 10.0, stride: float = 5.0,
                          ds_stride: float = 0.06, ctx_ds: float = 5.0,
                          ctx_block: float = 50.0, min_pn: int = 1024,
                          rng: Optional[np.random.RandomState] = None,
                          rotate: bool = True,
                          covar_nn_size: float = 0.3) -> List[Dict]:
    """Scan -> 10 m training blocks EACH PAIRED with its 50 m context
    sub-cloud and per-point nearest-context indices -- the offline context
    prep (semantic3d_context_util.py:578-583 sample_context_block fan-out).

    The optional z-rotation is applied to the WHOLE scan before both the
    block sampler and the context downsample, so block and context stay in
    one rigid frame; ctx_xyz is stored block-relative (same origin as the
    block's xyz), ready for ``ContextFusionModel``.
    """
    rng = rng or np.random.RandomState()
    pts = np.asarray(points, np.float32)
    if rotate and rng.rand() > 0.3:
        pts = pts.copy()
        pts[:, :3] = augment.rotate_z(
            np.ascontiguousarray(pts[:, :3]), rng.rand() * np.pi / 2.0)
    blocks = sample_training_blocks(pts, labels, block_size=block_size,
                                    stride=stride, ds_stride=ds_stride,
                                    min_pn=min_pn, rng=rng, rotate=False,
                                    covar_nn_size=covar_nn_size)
    ctx_abs, ctx_feats = context_features(context_cloud(pts, ctx_ds))
    for b in blocks:
        b["ctx_xyz"], b["ctx_feats"], b["ctx_idx"] = context_window(
            b["xyz"], b["block_min"], ctx_abs, ctx_feats, ctx_block)
    return blocks


def context_features(ctx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """A ``context_cloud`` [m, 7] -> (absolute xyz [m, 3], features [m, 4]:
    rgb in [-1, 1] and the intensity standardised over the cloud)."""
    it = ctx[:, 3:4]
    it = (it - it.mean()) / (it.std() + 1e-6)
    return ctx[:, :3], np.concatenate([ctx[:, 4:7] / 127.5 - 1.0, it],
                                      1).astype(np.float32)


def context_window(block_xyz: np.ndarray, block_min: np.ndarray,
                   ctx_abs: np.ndarray, ctx_feats: np.ndarray,
                   ctx_block: float = 50.0
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One block's context: the context points within ``ctx_block`` / 2 of
    ``block_min`` in x and y (the nearest one alone where none is), in the
    block's frame, their features, and each block point's nearest context
    point (``context_indices``).  Returns (ctx_xyz [m', 3], ctx_feats
    [m', 4], ctx_idx [n] int32)."""
    rel = ctx_abs - block_min[None, :]
    sel = (np.abs(rel[:, 0]) <= ctx_block / 2.0) \
        & (np.abs(rel[:, 1]) <= ctx_block / 2.0)
    if not sel.any():                        # degenerate scan: keep the
        sel = np.zeros(len(rel), bool)       # nearest voxel so the
        sel[np.argmin((rel[:, :2] ** 2).sum(1))] = True  # gather works
    cx = rel[sel].astype(np.float32)
    return cx, ctx_feats[sel], context_indices(block_xyz, cx)


def context_blocks_from_list(model: str, blocks: List[Dict],
                             rng: Optional[np.random.RandomState] = None
                             ) -> List[Dict]:
    """The context pipeline's read of a pkl of ``prepare_context_scene``
    blocks already loaded (the JAX ``context_blocks_from_pkl``,
    semantic3d.py:281-311, train_gpn_semantic3d_context.py:50-71 feed):
    train-time flips are applied to block AND context cloud together (one
    rigid frame: the nearest-context relation is mirror-invariant), color
    jitter on the block features only."""
    rng = rng or np.random.RandomState()
    out = []
    for b in blocks:
        xyz, feats = b["xyz"], b["feats"]
        cx, cf = b["ctx_xyz"], b["ctx_feats"]
        if model == "train":
            if rng.rand() < 0.5:
                xyz = augment.flip(xyz, 0)
                cx = augment.flip(cx, 0)
            if rng.rand() < 0.5:
                xyz = augment.flip(xyz, 1)
                cx = augment.flip(cx, 1)
            feats = feats.copy()
            feats[:, :3] += rng.uniform(-0.02, 0.02, (len(feats), 3))
        out.append({"xyz": xyz.astype(np.float32),
                    "feats": feats.astype(np.float32),
                    "labels": b["labels"].astype(np.int32),
                    "ctx_xyz": cx.astype(np.float32),
                    "ctx_feats": cf.astype(np.float32),
                    "ctx_idx": np.asarray(b["ctx_idx"], np.int32)})
    return out
