"""Full-scene evaluation CLI of the port (counterpart of
``scripts/interpolate.py``): restore a checkpoint, sweep each scene's
blocks through the model, interpolate the per-point probabilities onto the
scene's cloud with Gaussian k-NN, and score the labels.

Usage (S3DIS rooms prepared with ``data.s3dis.prepare_room``):
  python -m pointcloudsegmentation_tpu_torch.interpolate --config s3dis \
      --checkpoint-dir model/ --scene-dir data/rooms --out-dir results/
Synthetic self-check (no data needed; random weights unless a
``--checkpoint-dir`` is given):
  python -m pointcloudsegmentation_tpu_torch.interpolate --synthetic

A scene's features are built as the training read_fn builds them (for
S3DIS, rgb and the covariance features when the config's feat_dim is above
3), so a checkpoint trained on prepared rooms restores.  Labels equal to
the config's ignore label are left out of the score, and with ignore label
0 the rest shift down by one, as in training.  Per-scene metrics go to
``<out-dir>/scene_eval.json``.  It runs on the card unless ``--device cpu``
is given.  The JAX script's ``--rot-ensemble``, ``--labels-out``, the
context and dense pipelines' scenes, ``--exact-search`` and the Semantic3D
scenes (their interpolation ratio and scene reader) are not ported yet
(ROADMAP.md M8b), so ``--config`` takes ``s3dis`` and ``scannet`` and a
model with inputs beyond the block is refused.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import time
from typing import Dict, List

import numpy as np
import torch

from .config import CONFIGS, require_device
from .data import blocks_fn_for, io_util, toy
from .data.batching import pad_block
from .eval.interpolate import (S3DIS_RATIO, eval_scene_probs,
                               interpolate_to_dense, scene_iou)
from .train.checkpoint import CheckpointManager
from .train.loop import Trainer
from .utils.logging import get_logger

# the configs whose scenes this eval reads (S3DIS_RATIO, the room and
# scene readers); Semantic3D waits for ROADMAP.md M8b
SCENE_CONFIGS = ("s3dis", "scannet")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", choices=SCENE_CONFIGS, default="s3dis")
    p.add_argument("--model", type=str, default=None,
                   help="override the config's model registry key")
    p.add_argument("--checkpoint-dir", type=str, default=None)
    p.add_argument("--scene-dir", type=str, default=None,
                   help="dir of per-scene pkls (sampled blocks + mins)")
    p.add_argument("--out-dir", type=str, default="results")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--num-points", type=int, default=None,
                   help="override block size (small CPU self-checks)")
    p.add_argument("--knn", type=int, default=6)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def load_blocks(path: str, cfg, config_name: str,
                rng: np.random.RandomState) -> List[Dict]:
    """A prepared scene pkl -> padded blocks with their ``block_min``,
    features as the config's training read_fn gives them."""
    data = io_util.read_pkl(path)
    blocks = blocks_fn_for(cfg, config_name)("test", data)
    out = []
    for b, bmin in zip(blocks, data["block_mins"]):
        pb = pad_block(b["xyz"], b["feats"], b["labels"],
                       cfg.data.num_points, rng)
        pb["block_min"] = np.asarray(bmin, np.float32)
        out.append(pb)
    return out


def synthetic_blocks(cfg) -> List[Dict]:
    """One synthetic scene: 4 room blocks side by side (seed 0)."""
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


def eval_scene(model, blocks: List[Dict], cfg, knn: int) -> Dict:
    """Sweep ``blocks``, interpolate onto the scene's cloud (the blocks'
    valid points at their absolute positions) and score it."""
    t0 = time.perf_counter()
    sxyz, sprobs = eval_scene_probs(model, blocks)
    dense_xyz = np.concatenate(
        [b["xyz"][b["mask"]] + b["block_min"] for b in blocks], 0)
    dense_labels = np.concatenate(
        [b["labels"][b["mask"]] for b in blocks], 0)
    qprobs = interpolate_to_dense(sxyz, sprobs, dense_xyz, k=knn,
                                  ratio=S3DIS_RATIO)
    seconds = time.perf_counter() - t0
    labels, keep = scored_labels(dense_labels, cfg.data.ignore_label)
    res = scene_iou(labels[keep], qprobs.argmax(1)[keep],
                    cfg.data.num_classes)
    return {"res": res, "probs": qprobs, "points": len(dense_xyz),
            "seconds": seconds}


def main(argv=None):
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
    trainer = Trainer(cfg, device=device)
    extra = getattr(trainer.model, "extra_keys", ())
    if extra:
        raise SystemExit(f"{cfg.model} needs {list(extra)} for every "
                         "block, which no scene pkl holds yet (ROADMAP.md "
                         "M8b)")
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
        scenes = [("synthetic", synthetic_blocks(cfg))]
    else:
        if not args.scene_dir:
            raise SystemExit("--scene-dir is required without --synthetic")
        files = sorted(glob.glob(os.path.join(args.scene_dir, "*.pkl")))
        if not files:
            raise FileNotFoundError(f"no .pkl files in {args.scene_dir}")
        rng = np.random.RandomState(0)
        scenes = [(os.path.splitext(os.path.basename(f))[0],
                   load_blocks(f, cfg, args.config, rng)) for f in files]

    results = []
    for name, blocks in scenes:
        r = eval_scene(model, blocks, cfg, args.knn)
        r["name"] = name
        log.info("%s: mIoU %.4f oAcc %.4f over %d points in %.3f s", name,
                 r["res"]["miou"], r["res"]["oacc"], r["points"],
                 r["seconds"])
        results.append(r)
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "scene_eval.json"), "w") as f:
        json.dump([{"name": r["name"], "miou": float(r["res"]["miou"]),
                    "oacc": float(r["res"]["oacc"]),
                    "iou": [float(x) for x in r["res"]["iou"]],
                    "points": r["points"], "seconds": r["seconds"]}
                   for r in results], f, indent=2)
    return results


if __name__ == "__main__":
    main()
