"""Seeded synthetic outdoor scans in Semantic3D's raw layout, and the
padded training batches their blocks give a Semantic3D model, as the train
CLI's ``Provider`` serves them (for ``chip_smoke.py`` and
``profile_train``; real Semantic3D scans are not in the repository).

As a program it writes a scan, or the 120 m scene around it, as a
Semantic3D ``.txt`` + ``.labels`` pair for the prep CLI:

  python -m pointcloudsegmentation_tpu_torch.data.synth_outdoor \
      --what scene --seed 0 --out data/sem3d/scene0.txt
"""
from __future__ import annotations

import argparse
from typing import Callable, Dict, List

import numpy as np

from . import semantic3d
from .provider import Provider

# colours and return intensity by class (0..8)
_RGB = np.array([[128, 128, 128], [90, 90, 95], [110, 140, 70],
                 [40, 110, 40], [80, 150, 60], [180, 160, 140],
                 [150, 150, 150], [200, 40, 200], [170, 30, 30]])
_INTENSITY = np.array([-500, 300, -800, -1200, -900, 600, 200, 0, 900])
# the near scan's extent in x and y (m)
SCAN_X, SCAN_Y = 22.0, 27.0


def _points(xyz, lab, rng):
    """[n, 7] float32 x y z intensity r g b: each class's colour and
    return intensity, with noise."""
    rgb = np.clip(_RGB[lab] + rng.randn(len(lab), 3) * 12, 0, 255)
    inten = _INTENSITY[lab] + rng.randn(len(lab)) * 150
    return np.concatenate([xyz, inten[:, None], rgb], 1).astype(np.float32)


def _ground(x, y):
    return 0.3 * np.sin(x / 7.0) + 0.2 * np.cos(y / 5.0)


def outdoor_scan(seed):
    """A seeded synthetic outdoor scan in Semantic3D's raw layout: [n, 7]
    float32 x y z intensity r g b over 22 x 27 m at about 5 cm spacing,
    and int32 labels 0..8: rolling ground (1 man-made terrain on a road
    strip, 2 natural terrain elsewhere), low vegetation (4), two building
    facades (5), trees (3: trunk and crown), a low wall (6), cars (8), and
    2% of the points unlabeled (0) or speckle artefacts (7)."""
    rng = np.random.RandomState(seed)
    wx, wy = SCAN_X, SCAN_Y
    parts, labels = [], []

    def add(xyz, label):
        parts.append(xyz)
        labels.append(np.full(len(xyz), label, np.int32))

    n = int(wx * wy / 0.05 ** 2)
    x, y = rng.uniform(0, wx, n), rng.uniform(0, wy, n)
    g = np.stack([x, y, _ground(x, y) + 0.01 * rng.randn(n)], 1)
    road = np.abs(x - 8.0) < 3.0
    add(g[road], 1)
    add(g[~road], 2)
    for _ in range(6):                      # low vegetation patches
        c = rng.uniform([12, 0], [wx, wy])
        m = 1500
        p = c + rng.randn(m, 2) * 0.8
        add(np.stack([p[:, 0], p[:, 1], _ground(p[:, 0], p[:, 1])
                      + rng.uniform(0, 0.5, m)], 1), 4)
    for x0 in (0.5, 20.5):                  # building facades along y
        m = int(wy * 8.0 / 0.05 ** 2)
        add(np.stack([x0 + 0.02 * rng.randn(m), rng.uniform(0, wy, m),
                      rng.uniform(0, 8.0, m)], 1), 5)
    for _ in range(5):                      # trees: trunk and crown
        cx, cy = rng.uniform([13, 1], [19, wy - 1])
        z0 = _ground(cx, cy)
        m = 800
        t = rng.uniform(0, 2 * np.pi, m)
        add(np.stack([cx + 0.15 * np.cos(t), cy + 0.15 * np.sin(t),
                      z0 + rng.uniform(0, 2.5, m)], 1), 3)
        d = rng.randn(6000, 3)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        add(np.array([cx, cy, z0 + 4.0]) + d * rng.uniform(1.5, 2.0, (6000, 1))
            * np.array([1.0, 1.0, 0.8]), 3)
    m = int(wy * 1.0 / 0.05 ** 2)           # a low wall beside the road
    add(np.stack([11.2 + 0.02 * rng.randn(m), rng.uniform(0, wy, m),
                  rng.uniform(0, 1.0, m)], 1), 6)
    for cy in (3.0, 11.0, 19.0):            # cars on the road
        lo = np.array([6.5, cy, _ground(8.0, cy)])
        hi = lo + np.array([1.8, 4.2, 1.5])
        m = 6000
        p = rng.uniform(lo, hi, (m, 3))
        face = rng.randint(0, 3, m)
        p[np.arange(m), face] = np.where(rng.rand(m) < 0.5, lo[face],
                                         hi[face])
        add(p, 8)
    xyz = np.concatenate(parts).astype(np.float32)
    lab = np.concatenate(labels)
    flip = rng.rand(len(lab)) < 0.02
    lab[flip] = rng.choice([0, 7], int(flip.sum()))
    speckle = lab == 7
    xyz[speckle] += rng.randn(int(speckle.sum()), 3).astype(np.float32) * 0.3
    return _points(xyz, lab, rng), lab


def outdoor_scene(seed):
    """``outdoor_scan`` at the centre of a 120 x 120 m scene, as a
    terrestrial scanner sees it: beyond the near scan the points thin out
    to about 0.25 m spacing over ground that rises into hills, 30
    buildings 8-28 m tall (walls and roof) and 400 trees with crowns up to
    24 m.  A 10 m block's 50 m context window there holds a few hundred 5 m
    voxels, some windows more than ``models.context.CTX_CAP``.  Returns
    ([n, 7] float32 points, int32 labels)."""
    pts, lab = outdoor_scan(seed)
    rng = np.random.RandomState([seed, 1])
    cx, cy, half, step = SCAN_X / 2, SCAN_Y / 2, 60.0, 0.25
    parts, labels = [], []

    def add(xyz, label):
        parts.append(np.asarray(xyz, np.float64))
        labels.append(np.full(len(xyz), label, np.int32))

    def hill(x, y):
        r = np.hypot(x - cx, y - cy)
        return _ground(x, y) + (r > 18.0) * (
            0.12 * (r - 18.0) + 1.5 * np.sin((x + y) / 19.0))

    def outside(x, y, mx, my):
        return (np.abs(x - cx) > mx) | (np.abs(y - cy) > my)

    n = int((2 * half / step) ** 2)         # natural terrain around the scan
    x = rng.uniform(cx - half, cx + half, n)
    y = rng.uniform(cy - half, cy + half, n)
    far = outside(x, y, SCAN_X / 2 + 0.5, SCAN_Y / 2 + 0.5)
    x, y = x[far], y[far]
    add(np.stack([x, y, hill(x, y) + 0.02 * rng.randn(len(x))], 1), 2)
    for _ in range(30):                     # buildings: walls and a roof
        while True:
            x0, y0 = rng.uniform([cx - half + 2, cy - half + 2],
                                 [cx + half - 22, cy + half - 22])
            if outside(x0 + 10, y0 + 10, 30.0, 32.0):
                break
        w, d, h = rng.uniform([8, 8, 8], [20, 20, 28])
        z0 = hill(x0 + w / 2, y0 + d / 2) - 0.5
        m = int((2 * (w + d) * h + w * d) / step ** 2)
        p = rng.uniform([x0, y0, z0], [x0 + w, y0 + d, z0 + h], (m, 3))
        face = rng.randint(0, 5, m)
        for f, (axis, v) in enumerate(((0, x0), (0, x0 + w), (1, y0),
                                       (1, y0 + d), (2, z0 + h))):
            p[face == f, axis] = v
        add(p, 5)
    for _ in range(400):                    # trees: trunk and crown
        while True:
            tx, ty = rng.uniform([cx - half, cy - half],
                                 [cx + half, cy + half])
            if outside(tx, ty, 16.0, 18.0):
                break
        z0 = hill(tx, ty)
        top, rad = rng.uniform([8, 2], [24, 4.5])
        m = int(top * 0.9 / step)
        add(np.stack([tx + 0.2 * rng.randn(m), ty + 0.2 * rng.randn(m),
                      z0 + rng.uniform(0, top * 0.7, m)], 1), 3)
        m = int(4 * np.pi * rad ** 2 / step ** 2)
        d = rng.randn(m, 3)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        add(np.array([tx, ty, z0 + top - rad])
            + d * rad * np.array([1.0, 1.0, 1.3]), 3)
    far_lab = np.concatenate(labels)
    far_pts = _points(np.concatenate(parts).astype(np.float32), far_lab, rng)
    return np.concatenate([pts, far_pts]), np.concatenate([lab, far_lab])


def scan_blocks(seed: int, min_pn: int, context: bool = False
                ) -> List[Dict]:
    """10 m training blocks of at least ``min_pn`` points, as the prep
    writes them: ``semantic3d.sample_training_blocks`` of the seeded
    ``outdoor_scan``, or with ``context`` (for the context pipeline)
    ``semantic3d.prepare_context_scene`` of the seeded ``outdoor_scene``,
    each block with its context cloud and indices, the blocks with the
    largest context clouds first: the context model's full load, and the
    clouds above the cap take ``batching.pad_context``'s cap branch."""
    rng = np.random.RandomState(seed)
    if context:
        pts, labels = outdoor_scene(seed)
        blocks = semantic3d.prepare_context_scene(pts, labels,
                                                  min_pn=min_pn, rng=rng)
        return sorted(blocks, key=lambda b: -len(b["ctx_xyz"]))
    pts, labels = outdoor_scan(seed)
    return semantic3d.sample_training_blocks(pts, labels, min_pn=min_pn,
                                             rng=rng)


def scan_batches(blocks_fn: Callable[..., List[Dict]], blocks: List[Dict],
                 num_points: int, batch_size: int, split: str, seed: int
                 ) -> List[Dict]:
    """``blocks`` read by ``blocks_fn`` (a model's read of loaded pkls,
    ``train.model_zoo.blocks_fn_for``: the flips and colour jitter of
    ``split``, the dense subset or the context fields) and padded to
    ``num_points`` and stacked by a ``Provider`` seeded with ``seed``:
    [B, ...] numpy batches."""
    rng = np.random.RandomState(seed)
    return list(Provider(["scan"], split, batch_size,
                         lambda model, _: blocks_fn(model, blocks, rng=rng),
                         num_points, seed=seed))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--what", choices=("scan", "scene"), default="scan")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", required=True, help="the .txt path")
    args = p.parse_args(argv)
    fn = outdoor_scan if args.what == "scan" else outdoor_scene
    points, labels = fn(args.seed)
    semantic3d.write_points_txt(args.out, points, labels)
    print(f"{args.out}: {len(points)} points")
    return len(points)


if __name__ == "__main__":
    main()
