"""Full-scene evaluation CLI of the port (counterpart of
``scripts/interpolate.py``): restore a checkpoint, sweep each scene's
blocks through the model (with ``--rot-ensemble K`` also each of its K
rotated arms), interpolate the per-point probabilities onto the scene's
dense cloud with Gaussian k-NN, average the arms, score the labels, and
write Semantic3D ``.labels`` submissions.

Usage (S3DIS rooms prepared with ``data.s3dis.prepare_room``):
  python -m pointcloudsegmentation_tpu_torch.interpolate --config s3dis \\
      --checkpoint-dir model/ --scene-dir data/rooms --out-dir results/
Semantic3D test scans (``prepare_data semantic3d_test --rotations 2``
wrote ``data/Semantic3D/test/`` and ``test_1/``, ``test_2/``):
  python -m pointcloudsegmentation_tpu_torch.interpolate --config semantic3d \\
      --checkpoint-dir model/ --scene-dir data/Semantic3D/test \\
      --rot-ensemble 2 --labels-out --out-dir results/
Synthetic self-check (no data needed; random weights unless a
``--checkpoint-dir`` is given):
  python -m pointcloudsegmentation_tpu_torch.interpolate --synthetic

Scenes.  A scene's blocks are read as the model's training read reads
prepared blocks in test mode (``train.model_zoo.blocks_fn_for``: for
S3DIS rgb and the covariance features when the config's feat_dim is above
3; ``dense_semantic3d``'s grid-downsampled subset beside each block's
dense cloud) and padded as the ``Provider`` pads them
(``data.batching.pad_fields``), so a checkpoint of the train CLI
restores.  An S3DIS room or ScanNet scene is interpolated onto its blocks'
points.  A Semantic3D scene (``data.semantic3d.save_eval_scene``) is
interpolated onto the scan's full-resolution points (``scan_xyz`` of arm
0's pkl, in file order; a pkl without them raises), so ``--labels-out``
writes one label per scan point; ``context_semantic3d`` gets each block's
50 m window of the scene's context cloud (``semantic3d.eval_scene_blocks``).

``--rot-ensemble K`` reads arm k's pkl of the same name from
``<scene-dir>_<k>`` (a missing arm raises ``FileNotFoundError``); each
arm's sampled points are rotated back into the scan's frame
(``eval_rot_ensemble_probs``) and interpolated, and the arms' probabilities
averaged.  ``--labels-out`` writes ``<out-dir>/<scene>.labels``: the
argmax over the model's columns plus 1, Semantic3D's labels 1..8.
``--exact-search`` builds the model with the exact global neighbor search
on every level (``build_model(windowed=False)``); ``--fast-search`` is
kept as a no-op.  The interpolation runs on the host, in the native
library's hash-grid k-NN.

Labels equal to the config's ignore label are left out of the score, and
with ignore label 0 the rest shift down by one, as in training; a scene
with no label left (a test scan) records ``miou: null``.  Per-scene
metrics go to ``<out-dir>/scene_eval.json``.  It runs on the card unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .config import CONFIGS, require_device
from .data import io_util, semantic3d, toy
from .data.augment import rotate_z
from .data.batching import pad_block, pad_fields
from .data.provider import DENSE_FACTOR
from .eval.interpolate import (S3DIS_RATIO, SEMANTIC3D_RATIO,
                               eval_rot_ensemble_probs, interpolate_to_dense,
                               save_semantic3d_labels, scene_iou)
from .models.context import CTX_CAP, CTX_FEAT_DIM
from .train.checkpoint import CheckpointManager
from .train.loop import Trainer
from .train.model_zoo import blocks_fn_for
from .utils.logging import get_logger

# the configs that have scenes, and their Gaussian ratios (ModelNet40 has
# clouds, and no dense cloud)
RATIOS = {"s3dis": S3DIS_RATIO, "scannet": S3DIS_RATIO,
          "semantic3d": SEMANTIC3D_RATIO}


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--config", choices=sorted(RATIOS), default="s3dis")
    p.add_argument("--model", type=str, default=None,
                   help="override the config's model registry key")
    p.add_argument("--checkpoint-dir", type=str, default=None)
    p.add_argument("--scene-dir", type=str, default=None,
                   help="dir of per-scene pkls (arm 0 with --rot-ensemble)")
    p.add_argument("--out-dir", type=str, default="results")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--num-points", type=int, default=None,
                   help="override block size (small CPU self-checks)")
    p.add_argument("--knn", type=int, default=6)
    p.add_argument("--rot-ensemble", type=int, default=0, metavar="K",
                   help="also sweep K k*pi/12-rotated arms, arm k from "
                        "<scene-dir>_<k>, and average the arms")
    p.add_argument("--labels-out", action="store_true",
                   help="write <out-dir>/<scene>.labels submissions")
    p.add_argument("--exact-search", action="store_true",
                   help="the exact global neighbor search on every level "
                        "instead of the windowed search the model trains "
                        "with (a diagnostic arm)")
    p.add_argument("--fast-search", action="store_true",
                   help="no-op: the windowed search is the default")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def read_scene(data, cfg, config_name: str, rng: np.random.RandomState,
               extra_keys: Sequence[str] = ()) -> List[Dict]:
    """A loaded scene pkl -> padded blocks with their ``block_min``, read
    by the model's read of prepared blocks in test mode."""
    read = blocks_fn_for(cfg, config_name)
    if config_name == "semantic3d":
        raw = semantic3d.eval_scene_blocks(data,
                                           context="ctx_idx" in extra_keys)
        mins = [b["block_min"] for b in raw]
        blocks = read("test", raw)
    else:
        mins = data["block_mins"]
        blocks = read("test", data)
    d = cfg.data
    out = []
    for b, bmin in zip(blocks, mins):
        pb = pad_fields(b, d.num_points, DENSE_FACTOR * d.num_points,
                        CTX_CAP, rng)
        pb["block_min"] = np.asarray(bmin, np.float32)
        out.append(pb)
    return out


def load_blocks(path: str, cfg, config_name: str,
                rng: np.random.RandomState,
                extra_keys: Sequence[str] = ()) -> List[Dict]:
    """``read_scene`` of the pkl at ``path``."""
    return read_scene(io_util.read_pkl(path), cfg, config_name, rng,
                      extra_keys)


def block_points(blocks: List[Dict]) -> Tuple[np.ndarray, np.ndarray]:
    """The blocks' valid points at their absolute positions, and their
    labels."""
    return (np.concatenate([b["xyz"][b["mask"]] + b["block_min"]
                            for b in blocks], 0),
            np.concatenate([b["labels"][b["mask"]] for b in blocks], 0))


def dense_cloud(data, blocks: List[Dict], config_name: str, path: str
                ) -> Tuple[np.ndarray, np.ndarray]:
    """The points a scene is labelled at, and their labels: a Semantic3D
    scan's full-resolution points (a pkl without them raises); else the
    blocks' points."""
    if config_name != "semantic3d":
        return block_points(blocks)
    if "scan_xyz" not in data:
        raise KeyError(f"{path} lacks the scan's points (scan_xyz): "
                       "prepare it with prepare_data semantic3d_test")
    return data["scan_xyz"], data["scan_labels"]


def rotate_block(pb: Dict, ang: float) -> Dict:
    """One padded block's absolute coordinates rotated by ``ang`` about z,
    re-anchored at the rotated minimum: the ``--synthetic`` stand-in for a
    prep-side rotation of the whole scan (JAX
    ``scripts/interpolate.py:224-245``).  The context and dense clouds
    turn with it."""
    out = dict(pb)
    absolute = rotate_z(
        np.ascontiguousarray(pb["xyz"] + pb["block_min"], np.float32), ang)
    bmin = absolute[pb["mask"]].min(0) if pb["mask"].any() \
        else np.zeros(3, np.float32)
    out["xyz"] = (absolute - bmin).astype(np.float32)
    out["block_min"] = bmin.astype(np.float32)
    for key in ("ctx_xyz", "dense_xyz"):
        if key in pb:
            out[key] = (rotate_z(np.ascontiguousarray(
                pb[key] + pb["block_min"], np.float32), ang)
                - bmin).astype(np.float32)
    return out


def add_synthetic_extras(pb: Dict, extra_keys: Sequence[str],
                         rng: np.random.RandomState) -> None:
    """Synthetic ``dense_*`` / ``ctx_*`` fields for a ``--synthetic``
    block (JAX ``scripts/interpolate.py:248-265``): the dense cloud is the
    block jittered by 1 cm; the context cloud an eighth of its points with
    their first ``CTX_FEAT_DIM`` features (Semantic3D's rgb and intensity:
    the port's ``ContextNet`` has a fixed input width, where flax sizes
    the JAX one from the first batch), each point's context index its
    nearest one of them."""
    if "dense_xyz" in extra_keys:
        jit = rng.normal(0, 0.01, pb["xyz"].shape).astype(np.float32)
        pb["dense_xyz"] = pb["xyz"] + jit
        pb["dense_feats"] = pb["feats"].copy()
        pb["dense_mask"] = pb["mask"].copy()
    if "ctx_xyz" in extra_keys:
        n = pb["xyz"].shape[0]
        sel = rng.choice(n, max(n // 8, 1), replace=False)
        pb["ctx_xyz"] = pb["xyz"][sel]
        pb["ctx_feats"] = pb["feats"][sel][:, :CTX_FEAT_DIM]
        pb["ctx_mask"] = pb["mask"][sel]
        d2 = ((pb["xyz"][:, None, :] - pb["ctx_xyz"][None, :, :])
              ** 2).sum(-1)
        pb["ctx_idx"] = d2.argmin(1).astype(np.int32)


def synthetic_blocks(cfg, extra_keys: Sequence[str] = ()) -> List[Dict]:
    """One synthetic scene: 4 room blocks side by side (seed 0), with the
    model's extra fields."""
    d = cfg.data
    rng = np.random.RandomState(0)
    blocks = []
    for i in range(4):
        blk = toy.synthetic_room_block(rng, n=d.num_points,
                                       num_classes=d.num_classes,
                                       feat_dim=max(d.feat_dim, 1))
        pb = pad_block(blk["xyz"], blk["feats"], blk["labels"],
                       d.num_points)
        pb["block_min"] = np.array([3.0 * i, 0, 0], np.float32)
        add_synthetic_extras(pb, extra_keys, rng)
        blocks.append(pb)
    return blocks


def scored_labels(labels: np.ndarray, ignore_label):
    """(labels as the loss sees them, points that count)."""
    keep = np.ones(len(labels), bool)
    if ignore_label is not None:
        keep = labels != ignore_label
        if ignore_label == 0:
            labels = np.maximum(labels - 1, 0)
    return labels, keep


def eval_scene(model, arms: List[Tuple[float, List[Dict]]],
               dense_xyz: np.ndarray, dense_labels: np.ndarray, cfg,
               knn: int, ratio: float = S3DIS_RATIO) -> Dict:
    """Sweep every arm's blocks, interpolate each arm onto ``dense_xyz``
    (in the scan's frame), average the arms and score the average:
    ``res`` is None where no point counts."""
    t0 = time.perf_counter()
    extra = getattr(model, "extra_keys", ())
    qprobs = None
    for sxyz, sprobs in eval_rot_ensemble_probs(model, arms, extra):
        qp = interpolate_to_dense(sxyz, sprobs, dense_xyz, k=knn,
                                  ratio=ratio)
        qprobs = qp if qprobs is None else qprobs + qp
    qprobs = qprobs / len(arms)
    seconds = time.perf_counter() - t0
    labels, keep = scored_labels(np.asarray(dense_labels),
                                 cfg.data.ignore_label)
    res = scene_iou(labels[keep], qprobs.argmax(1)[keep],
                    cfg.data.num_classes) if keep.any() else None
    return {"res": res, "probs": qprobs, "points": len(dense_xyz),
            "blocks": [len(b) for _, b in arms], "seconds": seconds}


def scenes_from_dir(args, cfg, extra_keys):
    """(name, arms, dense xyz, dense labels) per scene pkl of
    ``--scene-dir``, one scene at a time."""
    files = sorted(glob.glob(os.path.join(args.scene_dir, "*.pkl")))
    if not files:
        raise FileNotFoundError(f"no .pkl files in {args.scene_dir}")
    rng = np.random.RandomState(0)
    for path in files:
        data = io_util.read_pkl(path)
        blocks = read_scene(data, cfg, args.config, rng, extra_keys)
        dense_xyz, dense_labels = dense_cloud(data, blocks, args.config,
                                              path)
        del data
        arms = [(0.0, blocks)]
        for ri in range(1, args.rot_ensemble + 1):
            rpath = os.path.join(args.scene_dir.rstrip("/") + f"_{ri}",
                                 os.path.basename(path))
            if not os.path.exists(rpath):
                raise FileNotFoundError(
                    f"rotation arm {ri} missing: {rpath} (prepare_data "
                    f"semantic3d_test --rotations {args.rot_ensemble} "
                    f"writes it)")
            arms.append((semantic3d.ROT_STEP * ri,
                         load_blocks(rpath, cfg, args.config, rng,
                                     extra_keys)))
        yield (os.path.splitext(os.path.basename(path))[0], arms, dense_xyz,
               dense_labels)


def synthetic_scene(cfg, extra_keys, rot_ensemble: int):
    blocks = synthetic_blocks(cfg, extra_keys)
    angles = [semantic3d.ROT_STEP * ri for ri in range(1, rot_ensemble + 1)]
    arms = [(0.0, blocks)] + [(a, [rotate_block(b, a) for b in blocks])
                              for a in angles]
    yield ("synthetic", arms, *block_points(blocks))


def main(argv=None) -> List[Dict]:
    args = parse_args(argv)
    device = require_device(args.device)
    log = get_logger("pcs_torch.interpolate")
    over = {}
    if args.model:
        over["model"] = args.model
    if args.num_points:
        over["data_num_points"] = args.num_points
        over["data_caps"] = (args.num_points // 2, args.num_points // 8)
    cfg = CONFIGS[args.config](**over)
    if cfg.model == "gpn_modelnet40":
        raise SystemExit("a classification model labels clouds, not "
                         "scenes: use the train CLI's --eval")
    if args.exact_search:
        log.info("exact-search eval: the global neighbor search on every "
                 "level (a diagnostic arm: the model trained with the "
                 "windowed search)")
    if args.fast_search:
        log.info("--fast-search is a no-op: the windowed search is the "
                 "default")
    trainer = Trainer(cfg, device=device, windowed=not args.exact_search)
    extra = getattr(trainer.model, "extra_keys", ())
    if args.checkpoint_dir:
        ckpt = CheckpointManager(args.checkpoint_dir)
        state = trainer.init_state(state=ckpt.restore(device=device))
        ckpt.close()
    elif args.synthetic:
        state = trainer.init_state(torch.Generator().manual_seed(cfg.seed))
    else:
        raise SystemExit("--checkpoint-dir is required without --synthetic")
    model = trainer.bind(state).eval()

    if args.synthetic:
        scenes = synthetic_scene(cfg, extra, args.rot_ensemble)
    elif not args.scene_dir:
        raise SystemExit("--scene-dir is required without --synthetic")
    else:
        scenes = scenes_from_dir(args, cfg, extra)
    os.makedirs(args.out_dir, exist_ok=True)
    results = []
    for name, arms, dense_xyz, dense_labels in scenes:
        r = eval_scene(model, arms, dense_xyz, dense_labels, cfg, args.knn,
                       RATIOS[args.config])
        r["name"] = name
        if args.labels_out:
            path = os.path.join(args.out_dir, f"{name}.labels")
            save_semantic3d_labels(path, r["probs"])
            log.info("%s: wrote %s", name, path)
        score = "no labelled point" if r["res"] is None else \
            f"mIoU {r['res']['miou']:.4f} oAcc {r['res']['oacc']:.4f}"
        log.info("%s: %s over %d points, %d arm(s) of %s blocks, in %.3f s",
                 name, score, r["points"], len(arms), r["blocks"],
                 r["seconds"])
        results.append(r)
    with open(os.path.join(args.out_dir, "scene_eval.json"), "w") as f:
        json.dump([_record(r) for r in results], f, indent=2)
    return results


def _record(r: Dict) -> Dict:
    res = r["res"]
    return {"name": r["name"],
            "miou": None if res is None else float(res["miou"]),
            "oacc": None if res is None else float(res["oacc"]),
            "iou": None if res is None else [float(x) for x in res["iou"]],
            "points": r["points"], "blocks": r["blocks"],
            "seconds": r["seconds"]}


if __name__ == "__main__":
    main()
