"""High-fidelity synthetic S3DIS-like rooms for mIoU-parity studies (the
port's own copy of ``pointcloudsegmentation_tpu.data.synth_rooms``: the same
seed gives the same rooms and blocks).

The container ships no real datasets, but the accuracy tradeoffs of the
windowed search path (recall_target, overflow-slot capacity) concentrate on
exactly the geometry real rooms have and uniform noise does not: large
axis-aligned planes (ceiling/floor/walls) whose points are Morton-distant
yet metrically close, thin vertical structures (columns, boards, chair
backs), and dense furniture clusters.  This generator builds rooms with that
structure — surface-sampled planes at realistic point densities, furniture
as boxes/slabs, per-class color distributions — and feeds the SAME offline
prep as real data (``data.s3dis.prepare_room`` -> sample/normalize blocks),
so windowed-vs-exact A/B runs exercise the full production path.

Label set matches S3DIS (data/s3dis.py CLASS_NAMES): ceiling floor wall beam
column window door table chair sofa bookcase board clutter.

Reference analog: the real S3DIS rooms the reference trains on
(train_graph_pool_new.py:286 — 2000 blocks/epoch); fidelity targets the
statistics that matter for neighbor search, not photo-realism.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

CEILING, FLOOR, WALL, BEAM, COLUMN, WINDOW, DOOR = 0, 1, 2, 3, 4, 5, 6
TABLE, CHAIR, SOFA, BOOKCASE, BOARD, CLUTTER = 7, 8, 9, 10, 11, 12

# per-class mean rgb (0..1) + jitter scale: loosely S3DIS-like (walls and
# ceiling whitish, floor gray, wood furniture, dark boards)
_COLOR = {
    CEILING: ((0.85, 0.85, 0.82), 0.06),
    FLOOR: ((0.55, 0.52, 0.48), 0.08),
    WALL: ((0.78, 0.76, 0.70), 0.08),
    BEAM: ((0.70, 0.68, 0.62), 0.06),
    COLUMN: ((0.72, 0.70, 0.66), 0.06),
    WINDOW: ((0.55, 0.65, 0.75), 0.10),
    DOOR: ((0.50, 0.38, 0.25), 0.08),
    TABLE: ((0.60, 0.45, 0.28), 0.08),
    CHAIR: ((0.35, 0.30, 0.28), 0.10),
    SOFA: ((0.45, 0.25, 0.22), 0.10),
    BOOKCASE: ((0.52, 0.38, 0.24), 0.10),
    BOARD: ((0.92, 0.92, 0.90), 0.05),
    CLUTTER: ((0.45, 0.45, 0.45), 0.18),
}


def _sample_rect(rng, origin, u_vec, v_vec, density, jitter=0.004):
    """Sample a planar rectangle at ``density`` points/m² with small normal
    jitter (sensor noise)."""
    a = np.linalg.norm(u_vec) * np.linalg.norm(v_vec)
    n = max(int(rng.poisson(a * density)), 1)
    u = rng.rand(n)[:, None]
    v = rng.rand(n)[:, None]
    pts = np.asarray(origin)[None, :] + u * np.asarray(u_vec) \
        + v * np.asarray(v_vec)
    nrm = np.cross(u_vec, v_vec)
    nn = np.linalg.norm(nrm)
    if nn > 0:
        pts = pts + (rng.randn(n, 1) * jitter) * (nrm / nn)[None, :]
    return pts.astype(np.float32)


def _box(rng, lo, hi, density, faces="all"):
    """Surface-sample an axis-aligned box (what furniture looks like to a
    lidar scan — interiors are empty)."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    d = hi - lo
    parts = []
    face_list = []
    if faces in ("all", "no_bottom"):
        face_list += [((lo[0], lo[1], hi[2]), (d[0], 0, 0), (0, d[1], 0))]
    if faces == "all":
        face_list += [((lo[0], lo[1], lo[2]), (d[0], 0, 0), (0, d[1], 0))]
    for (o, u, v) in face_list:
        parts.append(_sample_rect(rng, o, u, v, density))
    for (o, u, v) in [
        ((lo[0], lo[1], lo[2]), (d[0], 0, 0), (0, 0, d[2])),
        ((lo[0], hi[1], lo[2]), (d[0], 0, 0), (0, 0, d[2])),
        ((lo[0], lo[1], lo[2]), (0, d[1], 0), (0, 0, d[2])),
        ((hi[0], lo[1], lo[2]), (0, d[1], 0), (0, 0, d[2])),
    ]:
        parts.append(_sample_rect(rng, o, u, v, density))
    return np.concatenate(parts, 0)


def _color_for(rng, label, n):
    mean, jit = _COLOR[label]
    c = np.asarray(mean)[None, :] + rng.randn(n, 3) * jit
    # per-object tint so color alone cannot solve the task
    c = c + rng.randn(1, 3) * 0.05
    return np.clip(c, 0.0, 1.0).astype(np.float32)


def _hard_postprocess(xyz: np.ndarray, labels: np.ndarray, rgb: np.ndarray,
                      rng: np.random.RandomState):
    """Real-scan failure modes the base generator lacks (VERDICT r4 #6):

    - density gradient: a virtual scanner position thins far surfaces
      ~1/r² (real S3DIS rooms were scanned from a few stations — density
      varies ~10x across a room, s3dis_util.py:32-138 data);
    - occlusion dropout: random spherical holes (furniture shadows);
    - sensor speckle: a sprinkle of floating outlier points labeled
      clutter (real scans carry reflection ghosts).
    """
    n = len(xyz)
    lo, hi = xyz.min(0), xyz.max(0)
    scanner = np.array([rng.uniform(lo[0] + 0.3, lo[0] + 1.5),
                        rng.uniform(lo[1] + 0.3, lo[1] + 1.5), 1.6],
                       np.float32)
    r2 = ((xyz - scanner[None, :]) ** 2).sum(1)
    keep_p = np.clip(4.0 / np.maximum(r2, 1.0), 0.12, 1.0)
    keep = rng.rand(n) < keep_p
    for _ in range(rng.poisson(3.0)):
        c = xyz[rng.randint(n)]
        rad = rng.uniform(0.2, 0.6)
        keep &= ((xyz - c[None, :]) ** 2).sum(1) > rad * rad
    if keep.sum() < 1024:  # degenerate draw — keep the room usable
        keep = np.ones(n, bool)
    xyz, labels, rgb = xyz[keep], labels[keep], rgb[keep]
    m = max(1, int(0.002 * len(xyz)))
    sp = np.stack([rng.uniform(lo[0], hi[0], m),
                   rng.uniform(lo[1], hi[1], m),
                   rng.uniform(lo[2], hi[2], m)], 1).astype(np.float32)
    xyz = np.concatenate([xyz, sp], 0)
    labels = np.concatenate([labels, np.full(m, CLUTTER, np.int32)], 0)
    rgb = np.concatenate([rgb, rng.rand(m, 3).astype(np.float32)], 0)
    return xyz, labels, rgb


def synthetic_s3dis_room(rng: Optional[np.random.RandomState] = None,
                         density: float = 1200.0,
                         hard: bool = False,
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """One room -> (points [n, 6] xyz+rgb, labels [n] int32).

    density: points/m² on structural surfaces (real S3DIS rooms run
    ~1-5k/m² before the 0.05 m grid downsample; the prep's ds_stride
    dominates the final density, so moderate values suffice).

    hard: real-scan failure modes — ~1/r² scanner-distance density
    gradient, spherical occlusion dropout, outlier speckle, and a rarer
    minority-class draw (sofa/board/column appear in ~half as many rooms,
    sharpening the class imbalance toward real S3DIS's inverse-log-weight
    regime).
    """
    rng = rng or np.random.RandomState()
    rare = 0.5 if hard else 1.0
    w = rng.uniform(4.0, 9.0)        # x extent
    dpt = rng.uniform(3.5, 8.0)      # y extent
    h = rng.uniform(2.7, 3.4)        # height

    pts: List[np.ndarray] = []
    lbl: List[np.ndarray] = []

    def add(p, label):
        pts.append(p)
        lbl.append(np.full(len(p), label, np.int32))

    # structure: floor, ceiling, 4 walls
    add(_sample_rect(rng, (0, 0, 0), (w, 0, 0), (0, dpt, 0), density), FLOOR)
    add(_sample_rect(rng, (0, 0, h), (w, 0, 0), (0, dpt, 0), density),
        CEILING)
    for (o, u) in [((0, 0, 0), (w, 0, 0)), ((0, dpt, 0), (w, 0, 0)),
                   ((0, 0, 0), (0, dpt, 0)), ((w, 0, 0), (0, dpt, 0))]:
        add(_sample_rect(rng, o, u, (0, 0, h), density), WALL)

    # beam under the ceiling (thin horizontal box spanning x)
    if rng.rand() < 0.5:
        by = rng.uniform(0.5, dpt - 0.5)
        add(_box(rng, (0, by - 0.15, h - 0.3), (w, by + 0.15, h), density),
            BEAM)
    # columns (thin vertical boxes at walls): the Morton worst case —
    # vertically extended, metrically tight
    for _ in range(rng.poisson(1.2 * rare)):
        cx = rng.uniform(0.3, w - 0.3)
        side = rng.choice([0.0, dpt])
        cy = np.clip(side + (0.25 if side == 0 else -0.25), 0.2, dpt - 0.2)
        add(_box(rng, (cx - 0.2, cy - 0.2, 0), (cx + 0.2, cy + 0.2, h),
                 density), COLUMN)

    # windows/doors/boards: rectangles ON walls (coplanar label boundaries)
    for _ in range(rng.poisson(1.5)):
        wx = rng.uniform(0.5, w - 1.6)
        add(_sample_rect(rng, (wx, 0.02, 1.0), (rng.uniform(0.8, 1.5), 0, 0),
                         (0, 0, rng.uniform(0.8, 1.4)), density), WINDOW)
    if rng.rand() < 0.9:
        dx = rng.uniform(0.5, w - 1.5)
        add(_sample_rect(rng, (dx, dpt - 0.02, 0), (1.0, 0, 0),
                         (0, 0, 2.1), density), DOOR)
    for _ in range(rng.poisson(1.0 * rare)):
        bx = rng.uniform(0.5, w - 2.0)
        add(_sample_rect(rng, (0.02, bx if bx < dpt - 1.5 else dpt - 1.5,
                               1.1), (0, rng.uniform(1.0, 1.8), 0),
                         (0, 0, 1.0), density), BOARD)

    # furniture: tables with chairs, sofas, bookcases at walls
    for _ in range(rng.poisson(2.0)):
        tx = rng.uniform(0.8, w - 1.8)
        ty = rng.uniform(0.8, dpt - 1.6)
        tw, td = rng.uniform(0.8, 1.8), rng.uniform(0.6, 1.0)
        th = rng.uniform(0.68, 0.78)
        # top slab + 4 legs
        add(_box(rng, (tx, ty, th - 0.04), (tx + tw, ty + td, th),
                 density * 1.5), TABLE)
        for (lx, ly) in [(tx, ty), (tx + tw - 0.05, ty),
                         (tx, ty + td - 0.05), (tx + tw - 0.05,
                                                ty + td - 0.05)]:
            add(_box(rng, (lx, ly, 0), (lx + 0.05, ly + 0.05, th - 0.04),
                     density), TABLE)
        # chairs around the table
        for _ in range(rng.poisson(2.0)):
            cx = tx + rng.uniform(-0.5, tw + 0.1)
            cy = ty + rng.uniform(-0.5, td + 0.1)
            add(_box(rng, (cx, cy, 0.38), (cx + 0.45, cy + 0.45, 0.45),
                     density * 1.5), CHAIR)                  # seat
            add(_box(rng, (cx, cy, 0.45), (cx + 0.05, cy + 0.45, 0.95),
                     density), CHAIR)                        # back
    if rng.rand() < 0.4 * rare:
        sx = rng.uniform(0.5, w - 2.2)
        add(_box(rng, (sx, 0.1, 0), (sx + 1.8, 0.95, 0.75), density), SOFA)
        add(_box(rng, (sx, 0.1, 0.75), (sx + 1.8, 0.35, 1.05), density),
            SOFA)
    for _ in range(rng.poisson(1.0)):
        bx = rng.uniform(0.3, w - 1.3)
        # vertical slab structure against a wall: shelves
        for sh in np.arange(0.0, 1.9, 0.4):
            add(_box(rng, (bx, dpt - 0.42, sh), (bx + 1.0, dpt - 0.1,
                                                 sh + 0.03), density * 1.5),
                BOOKCASE)
        add(_box(rng, (bx, dpt - 0.42, 0), (bx + 0.03, dpt - 0.1, 1.9),
                 density), BOOKCASE)
        add(_box(rng, (bx + 0.97, dpt - 0.42, 0), (bx + 1.0, dpt - 0.1,
                                                   1.9), density), BOOKCASE)

    # clutter: small boxes on tables/floor + scattered points
    for _ in range(rng.poisson(6.0)):
        cx, cy = rng.uniform(0.3, w - 0.5), rng.uniform(0.3, dpt - 0.5)
        cz = rng.choice([0.0, 0.75])
        s = rng.uniform(0.1, 0.4)
        add(_box(rng, (cx, cy, cz), (cx + s, cy + s, cz + s), density),
            CLUTTER)

    xyz = np.concatenate(pts, 0)
    labels = np.concatenate(lbl, 0)
    rgb = np.concatenate([_color_for(rng, int(lb[0]), len(p))
                          for p, lb in zip(pts, lbl)], 0)
    if hard:
        xyz, labels, rgb = _hard_postprocess(xyz, labels, rgb, rng)
    # prepare_room/normalize_block expects sensor-range rgb (0..255, like the
    # real S3DIS .txt rooms) and maps it to ~[-1, 1] via (c-128)/130.5;
    # feeding unit-range colors would collapse every class to ~-0.98.
    points = np.concatenate([xyz, rgb * 255.0], 1).astype(np.float32)
    perm = rng.permutation(len(points))
    return points[perm], labels[perm]


def synthetic_s3dis_building(rng: Optional[np.random.RandomState] = None,
                             num_rooms: int = 2, hard: bool = False,
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Multi-room SCENE: rooms placed side by side along x with abutting
    walls, so sampled blocks span room boundaries (back-to-back double
    walls, mixed contexts) the way real S3DIS areas do — single-room
    generators never produce blocks that straddle two rooms."""
    rng = rng or np.random.RandomState()
    all_pts, all_lbl = [], []
    xoff = 0.0
    for _ in range(num_rooms):
        points, labels = synthetic_s3dis_room(rng, hard=hard)
        points = points.copy()
        points[:, 0] += xoff - points[:, 0].min()
        all_pts.append(points)
        all_lbl.append(labels)
        xoff = points[:, 0].max() + 0.08   # abutting double wall
    return (np.concatenate(all_pts, 0).astype(np.float32),
            np.concatenate(all_lbl, 0))


def room_blocks(rng: Optional[np.random.RandomState] = None,
                num_rooms: int = 1, use_covars: bool = True,
                block_size: float = 3.0, ds_stride: float = 0.05,
                model: str = "train",
                with_mins: bool = False,
                hard: bool = False,
                rooms_per_scene: int = 1) -> List[Dict]:
    """Rooms -> training blocks through the REAL offline+online prep
    (s3dis.prepare_room + blocks_from_room_pkl semantics, in memory).

    ``with_mins=True`` additionally carries each block's absolute origin
    ("block_min") so scene-level eval can reassemble the room
    (eval_scene_probs adds it back).  ``hard=True`` enables the real-scan
    failure modes (density gradient, occlusion, speckle, rarer minority
    classes); ``rooms_per_scene>1`` cuts blocks from multi-room buildings
    so blocks straddle room boundaries."""
    from . import augment
    from . import s3dis

    rng = rng or np.random.RandomState()
    out: List[Dict] = []
    for _ in range(num_rooms):
        if rooms_per_scene > 1:
            points, labels = synthetic_s3dis_building(
                rng, num_rooms=rooms_per_scene, hard=hard)
        else:
            points, labels = synthetic_s3dis_room(rng, hard=hard)
        prep = s3dis.prepare_room(points, labels, ds_stride=ds_stride,
                                  block_size=block_size, rng=rng)
        for i in range(len(prep["xyzs"])):
            xyz, rgb = prep["xyzs"][i], prep["rgbs"][i]
            if model == "train":
                xyz, rgb = augment.train_time_augment(xyz, rgb, rng)
            feats = (np.concatenate([rgb, prep["covars"][i]], 1)
                     if use_covars else rgb).astype(np.float32)
            blk = {"xyz": xyz.astype(np.float32), "feats": feats,
                   "labels": np.asarray(prep["lbls"][i],
                                        np.int32).reshape(-1)}
            if with_mins:
                blk["block_min"] = np.asarray(prep["block_mins"][i],
                                              np.float32)
            out.append(blk)
    return out
