"""Host-side block sampling + augmentation (numpy/scipy): the port's own
copy of ``pointcloudsegmentation_tpu.data.augment``.  It takes the native
host library where the JAX package takes it (``grid_downsample``, and
``compute_covars`` with ``query_idx``) and scipy where the JAX package takes
scipy, so the arrays are equal; a native library that fails to build
raises (``data/native.py``) instead of falling back to numpy.

Reimplements the reference's ``aug_util.py`` pipeline and the external
``libPointUtil`` native calls it depends on (SURVEY.md §2.3):

- ``grid_downsample``       = gridDownsampleGPU (aug_util.py:150,181,245)
- ``radius_neighbors_host`` = findNeighborRadiusCPU/GPU (aug_util.py:183,247)
- ``compute_covars``        = computeCovarsGPU (aug_util.py:189,253)
- ``uniform_sample_block``  = aug_util.py:57-82 (3 m blocks, 1.5 m stride)
- ``sample_block``          = aug_util.py:141-206 (downsample + augment +
  covars + crop)
- flips/swap/rescale/rotate = aug_util.py:9-35,153-179
- ``normalize_block``       = s3dis_util.py:92-137 (center xy, rgb to [-1,1],
  clip labels)
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from . import native

try:
    from scipy.spatial import cKDTree
except ImportError:  # pragma: no cover
    cKDTree = None


# ---------------------------------------------------------------- transforms
def flip(points: np.ndarray, axis: int = 0) -> np.ndarray:
    out = points.copy()
    out[:, axis] = -out[:, axis]
    return out


def swap_xy(points: np.ndarray) -> np.ndarray:
    out = points.copy()
    out[:, 0], out[:, 1] = points[:, 1].copy(), points[:, 0].copy()
    return out


def rotate_z(xyz: np.ndarray, angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    m = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], np.float32)
    return xyz @ m


# --------------------------------------------------------------- downsample
def grid_downsample(xyz: np.ndarray, stride: float) -> np.ndarray:
    """Indices of one representative point per occupied voxel (the contract
    of libPointUtil.gridDownsampleGPU), from the native host library."""
    return native.grid_downsample(xyz, stride)


def radius_neighbors_host(xyz: np.ndarray, radius: float,
                          query_idx: Optional[np.ndarray] = None
                          ) -> List[np.ndarray]:
    """Ragged radius neighborhoods on the host (findNeighborRadiusCPU)."""
    assert cKDTree is not None, "scipy required for host radius search"
    tree = cKDTree(xyz)
    queries = xyz if query_idx is None else xyz[query_idx]
    return tree.query_ball_point(queries, radius)


def compute_covars(xyz: np.ndarray, radius: float = 0.1,
                   query_idx: Optional[np.ndarray] = None) -> np.ndarray:
    """9-dim local covariance features (computeCovarsGPU): trace-normalized
    covariance of each query's radius neighborhood: the native host library
    for a ``query_idx``, scipy's cKDTree for every point."""
    if query_idx is not None:
        return native.compute_covars(xyz, query_idx, radius)
    nbrs = radius_neighbors_host(xyz, radius, query_idx)
    n = len(nbrs)
    out = np.zeros((n, 9), np.float32)
    for i, idx in enumerate(nbrs):
        pts = xyz[idx]
        if len(pts) < 2:
            continue
        d = pts - pts.mean(0, keepdims=True)
        cov = d.T @ d / len(pts)
        tr = np.trace(cov)
        out[i] = (cov / (tr + 1e-6)).reshape(9)
    return out


# ------------------------------------------------------------- block crops
def _stride_starts(maxv: float, block: float, stride: float) -> np.ndarray:
    """Block origins with no back-sampling (get_list_without_back_sample,
    aug_util.py:38-54 semantics): cover [0, maxv] with stride, last block
    clamped so it ends at maxv."""
    if maxv <= block:
        return np.array([0.0], np.float32)
    starts = np.arange(0.0, maxv - block + 1e-6, stride, dtype=np.float32)
    if starts[-1] + block < maxv:
        starts = np.append(starts, np.float32(maxv - block))
    return starts


def uniform_sample_block(xyz: np.ndarray, block_size: float = 3.0,
                         stride: float = 1.5, min_pn: int = 2048,
                         normalized: bool = True) -> List[np.ndarray]:
    """Index lists of xy-window crops (aug_util.py:57-82)."""
    if not normalized:
        xyz = xyz - xyz.min(0, keepdims=True)
    maxx, maxy = xyz[:, 0].max(), xyz[:, 1].max()
    idxs = []
    for x0 in _stride_starts(maxx, block_size, stride):
        xc = (xyz[:, 0] >= x0) & (xyz[:, 0] < x0 + block_size)
        for y0 in _stride_starts(maxy, block_size, stride):
            cond = xc & (xyz[:, 1] >= y0) & (xyz[:, 1] < y0 + block_size)
            if cond.sum() >= min_pn:
                idxs.append(np.nonzero(cond)[0])
    return idxs


# ------------------------------------------------------------ full pipeline
def sample_block(points: np.ndarray, labels: np.ndarray, ds_stride: float,
                 block_size: float, block_stride: float, min_pn: int,
                 rng: Optional[np.random.RandomState] = None,
                 use_rescale: bool = False, use_flip: bool = False,
                 use_rotate: bool = False, covar_ds_stride: float = 0.03,
                 covar_nn_size: float = 0.1
                 ) -> Tuple[List, List, List, List]:
    """aug_util.sample_block: covar-grid downsample -> flips/rescale/rotate
    -> model-grid downsample -> covariance feats -> block crops.

    points: [n, 6] xyz+rgb; labels: [n].
    Returns per-block lists (xyzs, rgbs, covars, lbls).
    """
    rng = rng or np.random.RandomState()
    xyz = np.ascontiguousarray(points[:, :3], np.float32)
    rgb = np.ascontiguousarray(points[:, 3:], np.float32)

    cd_idx = grid_downsample(xyz, covar_ds_stride)
    cd_xyz = xyz[cd_idx]
    min_xyz = xyz.min(0, keepdims=True)

    if use_flip:
        if rng.rand() < 0.5:
            cd_xyz = swap_xy(cd_xyz)
            min_xyz = swap_xy(min_xyz)
        if rng.rand() < 0.5:
            cd_xyz = flip(cd_xyz, 0)
            min_xyz[:, 0] = cd_xyz[:, 0].min()
        if rng.rand() < 0.5:
            cd_xyz = flip(cd_xyz, 1)
            min_xyz[:, 1] = cd_xyz[:, 1].min()
    if use_rescale:
        scale = rng.uniform(0.9, 1.1, (1, 3)).astype(np.float32)
        cd_xyz = cd_xyz * scale
        min_xyz = min_xyz * scale
    if use_rotate and rng.rand() > 0.3:
        cd_xyz = rotate_z(cd_xyz, rng.rand() * np.pi / 2.0)

    ds_idx = grid_downsample(cd_xyz, ds_stride)
    covars = compute_covars(cd_xyz, covar_nn_size, ds_idx)

    xyz_s = cd_xyz[ds_idx]
    rgb_s = rgb[cd_idx][ds_idx]
    lbl_s = labels[cd_idx][ds_idx]

    rel = xyz_s - min_xyz
    crops = uniform_sample_block(rel, block_size, block_stride,
                                 min_pn=min_pn)
    xyzs = [xyz_s[i] for i in crops]
    rgbs = [rgb_s[i] for i in crops]
    cvs = [covars[i] for i in crops]
    lbls = [lbl_s[i] for i in crops]
    return xyzs, rgbs, cvs, lbls


def normalize_block(xyzs: List[np.ndarray], rgbs: List[np.ndarray],
                    lbls: List[np.ndarray], bsize: float = 3.0,
                    max_label: int = 12,
                    jitter_color: Optional[np.random.RandomState] = None
                    ) -> Tuple[List, List, List, List]:
    """s3dis_util.normalize_block (:92-137): center each block's xy at 0
    (min + bsize/2 subtracted), rgb -> ~[-1, 1], labels clipped; returns
    block_mins for full-scene reconstruction."""
    block_mins = []
    out_xyz, out_rgb, out_lbl = [], [], []
    for xyz, rgb, lbl in zip(xyzs, rgbs, lbls):
        mn = xyz.min(0, keepdims=True).copy()
        mn[:, :2] += bsize / 2.0
        out_xyz.append(xyz - mn)
        block_mins.append(mn[0])
        r = rgb.astype(np.float32)
        if jitter_color is not None:
            r = r + jitter_color.uniform(-2.5, 2.5, r.shape)
            r = (r - 128.0) / 130.5
        else:
            r = (r - 128.0) / 130.5
        out_rgb.append(r.astype(np.float32))
        out_lbl.append(np.minimum(lbl, max_label).astype(np.int32))
    return out_xyz, out_rgb, out_lbl, block_mins


def train_time_augment(xyz: np.ndarray, rgb: np.ndarray,
                       rng: np.random.RandomState
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """The reduced train-time augmentation of the flagship S3DIS trainer
    (train_graph_pool_new.py:263-272): random x/y flips, swap_xy, color
    jitter ±0.02 (blocks are already centered at 0)."""
    if rng.rand() < 0.5:
        xyz = flip(xyz, 0)
    if rng.rand() < 0.5:
        xyz = flip(xyz, 1)
    if rng.rand() < 0.5:
        xyz = swap_xy(xyz)
    rgb = rgb + rng.uniform(-0.02, 0.02, rgb.shape).astype(np.float32)
    return xyz, rgb.astype(np.float32)
