"""Offline dataset preparation CLI of the port (counterpart of
``scripts/prepare_data.py``): raw per-room, per-scene or per-scan files ->
the pkls the train CLI and the scene eval read.  Host code only (numpy and
the native host library); it uses no card.

  # S3DIS: rooms as pkls of (points [n, 6] xyz + rgb, labels [n])
  python -m pointcloudsegmentation_tpu_torch.prepare_data s3dis \\
      --raw-dir data/rooms --out-dir data/S3DIS/sampled_train --workers 8
  # ScanNet: scenes as pkls of (xyz [n, 3], labels [n]); also writes
  # <scene>.pkl.counts.npy and the class weights scannet_weights.txt
  python -m pointcloudsegmentation_tpu_torch.prepare_data scannet \\
      --raw-dir data/scannet --out-dir data/ScanNet/train
  # Semantic3D: .txt scans (+ .labels) -> 10 m training-block pkls
  python -m pointcloudsegmentation_tpu_torch.prepare_data semantic3d \\
      --raw-dir data/sem3d --out-dir data/Semantic3D/sampled_train \\
      [--offset-z-map data/Semantic3D/offset_z.txt]
  # ... the same blocks, each with its 50 m context cloud
  python -m pointcloudsegmentation_tpu_torch.prepare_data \\
      semantic3d_context --raw-dir data/sem3d --out-dir data/Semantic3D/ctx
  # Semantic3D test scans -> <out>/test/<scan>.pkl eval scenes, and with
  # --rotations K also the k*pi/12-rotated arms <out>/test_<k>/, k = 1..K
  python -m pointcloudsegmentation_tpu_torch.prepare_data semantic3d_test \\
      --raw-dir data/sem3d_test --out-dir data/Semantic3D --rotations 2
  # ModelNet40: pkls of [(xyz, label), ...] -> normalised clouds
  python -m pointcloudsegmentation_tpu_torch.prepare_data modelnet40 \\
      --raw-dir data/modelnet --out-dir data/ModelNet40/prepared

Seeding: each file's ``RandomState`` is seeded with ``zlib.crc32`` of its
basename (``file_rng``).  The JAX script seeds with Python's
``hash(path) % 2**31``, which Python salts per process, so it writes other
blocks on every run wherever the prep draws (``--augment-geometry``, the
Semantic3D training rotation).  With the basename's CRC the output depends
on the file alone: not on the run, the directory, or ``--workers`` (a
``multiprocessing.Pool`` of that many processes, one file per task).

``semantic3d_test`` writes the JAX scene columns and the arm's 5 m
context cloud (``data.semantic3d.save_eval_scene``), and into arm 0's pkl
alone the scan's full-resolution xyz in file order and its labels where a
``.labels`` file exists (else zeros), so the scene eval labels every scan
point and evaluates the context model.
"""
from __future__ import annotations

import argparse
import glob
import multiprocessing as mp
import os
import zlib
from functools import partial
from typing import List, Tuple

import numpy as np

from .data import augment, io_util, modelnet, native, s3dis, scannet, \
    semantic3d
from .utils.logging import get_logger

MODES = ("s3dis", "scannet", "semantic3d", "semantic3d_context",
         "semantic3d_test", "modelnet40")

log = get_logger("pcs_torch.prepare")


def file_rng(path: str) -> np.random.RandomState:
    """The file's own random stream: seeded with the CRC-32 of its
    basename."""
    return np.random.RandomState(zlib.crc32(os.path.basename(path).encode()))


def _stem(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def read_scan(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """A Semantic3D scan and its labels (zeros, unlabeled, without a
    ``.labels`` file)."""
    points, labels = semantic3d.read_points_txt(
        path, os.path.splitext(path)[0] + ".labels")
    if labels is None:
        labels = np.zeros(len(points), np.int32)
    return points, labels


def prep_s3dis_one(out_dir: str, augment_geometry: bool, path: str):
    points, labels = io_util.read_room_pkl(path)
    room = s3dis.prepare_room(points, labels, rng=file_rng(path),
                              augment_geometry=augment_geometry)
    out = os.path.join(out_dir, os.path.basename(path))
    io_util.save_pkl(out, room)
    return out, len(room["xyzs"])


def prep_scannet_one(out_dir: str, augment_geometry: bool, path: str):
    """A scene pkl of (xyz [n, 3], labels [n]) -> cropped blocks without
    colour, and the scene's label counts beside it
    (scannet_data_util.py:19-179)."""
    data = io_util.read_pkl(path)
    xyz = np.asarray(data[0], np.float32)
    labels = np.asarray(data[1], np.int32)
    scene = scannet.prepare_scene(xyz, labels, rng=file_rng(path),
                                  augment_geometry=augment_geometry)
    out = os.path.join(out_dir, os.path.basename(path))
    io_util.save_pkl(out, scene)
    counts = np.bincount(np.concatenate([np.ravel(l) for l in scene["lbls"]]),
                         minlength=scannet.NUM_CLASSES + 1)
    np.save(out + ".counts.npy", counts)
    return out, len(scene["xyzs"])


def prep_semantic3d_one(out_dir: str, path: str):
    points, labels = read_scan(path)
    blocks = semantic3d.sample_training_blocks(points, labels,
                                               rng=file_rng(path))
    out = os.path.join(out_dir, _stem(path) + ".pkl")
    semantic3d.save_blocks(out, blocks)
    return out, len(blocks)


def prep_semantic3d_context_one(out_dir: str, path: str):
    """A scan -> 10 m blocks each with its 50 m context cloud and nearest
    context indices (semantic3d_context_util.py:578-583)."""
    points, labels = read_scan(path)
    blocks = semantic3d.prepare_context_scene(points, labels,
                                              rng=file_rng(path))
    out = os.path.join(out_dir, _stem(path) + ".pkl")
    semantic3d.save_blocks(out, blocks)
    return out, len(blocks)


def prep_semantic3d_test_one(out_dir: str, rotations: int, path: str):
    """A test scan -> 50 m macro blocks -> deterministic 10 m eval blocks,
    one scene pkl per rotation arm: ``test/`` unrotated (with the scan's
    own points and labels), ``test_<k>/`` rotated by k·pi/12 (semantic3d_testset_presample_block and
    semantic3d_test_to_block[_with_rotate], semantic3d_util.py:466-557).
    Returns (arm 0's pkl, the blocks of every arm)."""
    points, labels = read_scan(path)
    macro = semantic3d.presample_test_blocks(points)
    first, total = None, 0
    for ri in range(rotations + 1):
        rot = semantic3d.ROT_STEP * ri
        blocks = []
        for m in macro:
            blocks.extend(semantic3d.process_test_blocks(m, rot_ang=rot))
        rotated = points
        if ri:
            rotated = points.copy()
            rotated[:, :3] = augment.rotate_z(
                np.ascontiguousarray(points[:, :3]), rot)
        out = os.path.join(out_dir, "test" if ri == 0 else f"test_{ri}",
                           _stem(path) + ".pkl")
        scan = (points[:, :3], labels) if ri == 0 else ()
        semantic3d.save_eval_scene(out, blocks,
                                   semantic3d.context_cloud(rotated), *scan)
        first = first or out
        total += len(blocks)
    return first, total


def prep_modelnet_one(out_dir: str, path: str):
    items = io_util.read_pkl(path)
    prepared = [(modelnet.prepare_cloud(np.asarray(x, np.float32), int(l)),
                 int(l)) for x, l in items]
    out = os.path.join(out_dir, os.path.basename(path))
    io_util.save_pkl(out, prepared)
    return out, len(prepared)


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("dataset", choices=MODES)
    p.add_argument("--raw-dir", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--workers", type=int,
                   default=max(1, (os.cpu_count() or 1) - 2),
                   help="processes, one file per task (the output does "
                        "not depend on it)")
    p.add_argument("--augment-geometry", action="store_true",
                   help="s3dis/scannet: offline flips, rescale and rotation "
                        "(the reference's sampled_train with-aug variant)")
    p.add_argument("--rotations", type=int, default=0,
                   help="semantic3d_test: also write K k*pi/12-rotated arms "
                        "test_1/ .. test_K/ (the reference writes up to 5)")
    p.add_argument("--offset-z-map", type=str, default=None,
                   help="semantic3d: also write the per-scan z-offset map "
                        "(semantic3d_train_offsetz.txt)")
    return p.parse_args(argv)


def main(argv=None) -> List[Tuple[str, int]]:
    """Prepare every raw file of ``--raw-dir``; returns (output, count)
    per file in file order."""
    args = parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    pattern = "*.txt" if args.dataset.startswith("semantic3d") else "*.pkl"
    files = sorted(glob.glob(os.path.join(args.raw_dir, pattern)))
    if not files:
        raise FileNotFoundError(f"no {pattern} in {args.raw_dir}")
    fn = {"s3dis": partial(prep_s3dis_one, args.out_dir,
                           args.augment_geometry),
          "scannet": partial(prep_scannet_one, args.out_dir,
                             args.augment_geometry),
          "semantic3d": partial(prep_semantic3d_one, args.out_dir),
          "semantic3d_context": partial(prep_semantic3d_context_one,
                                        args.out_dir),
          "semantic3d_test": partial(prep_semantic3d_test_one, args.out_dir,
                                     args.rotations),
          "modelnet40": partial(prep_modelnet_one, args.out_dir)}[
        args.dataset]

    if args.dataset == "semantic3d" and args.offset_z_map:
        semantic3d.write_offset_z_map(
            args.offset_z_map,
            ((_stem(f), semantic3d.read_points_txt(f)[0]) for f in files))
        log.info("wrote z-offset map %s", args.offset_z_map)

    native.build()      # once, before the workers load it
    if args.workers > 1:
        # spawned workers: the parent may hold a CUDA context or threads
        with mp.get_context("spawn").Pool(min(args.workers,
                                              len(files))) as pool:
            results = pool.map(fn, files, chunksize=1)
    else:
        results = [fn(f) for f in files]
    for out, n in results:
        log.info("%s: %d %s", out, n,
                 "clouds" if args.dataset == "modelnet40" else "blocks")

    if args.dataset == "scannet":
        # the scenes' label counts -> training class weights, the
        # unannotated class 0 left out (scannet_data_util.py:160-179)
        counts = sum(np.load(out + ".counts.npy") for out, _ in results)
        wpath = os.path.join(args.out_dir, "scannet_weights.txt")
        np.savetxt(wpath, scannet.class_weights_from_counts(counts[1:]))
        log.info("wrote class weights %s", wpath)
    return results


if __name__ == "__main__":
    main()
