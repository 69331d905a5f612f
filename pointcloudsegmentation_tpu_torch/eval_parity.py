"""Frozen-weights eval-time search parity: windowed against exact search
(the port's counterpart of ``scripts/eval_parity.py``).

Trains the flagship ``pointnet_s3dis`` once on synthetic S3DIS-like rooms
(``data/synth_rooms.py``, the JAX script's rooms and seeds; the windowed
search, as training always runs), then puts the SAME weights through the
whole scene eval twice: ``eval_scene_probs``' block sweep, Gaussian 6-NN
interpolation onto the dense cloud (``interpolate_to_dense``, the native
library) and ``scene_iou``.  The windowed arm is ``build_model(cfg)``; the
exact arm is ``build_model(cfg, windowed=False)`` (the exact global
search on every level, where the JAX script sets
``PCS_DISABLE_WINDOWED=1``) with the windowed arm's ``state_dict``.  Each
arm's mean scene mIoU and dense points labelled per second (the first
scene swept once untimed first) are written with ``delta_miou`` (windowed
- exact) and ``speedup`` (windowed / exact points/s).

Reference analog: interpolate.py:121-168 (eval_room_probs + interpolation),
which always ran the same search as training.

Usage (the JAX record's configuration):
  python -m pointcloudsegmentation_tpu_torch.eval_parity --epochs 10 \
      --out results/eval_parity_torch.json

It runs on the card unless ``--device cpu`` is given; on the card the JSON
carries the card's name and power limit under ``"card"``.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .config import require_device, s3dis_config
from .data import batching, synth_rooms
from .eval.interpolate import eval_scene_probs, interpolate_to_dense, \
    scene_iou
from .train.loop import Trainer
from .train.model_zoo import build_model
from .utils.logging import get_logger
from .utils.timing import card

SEARCH_CHUNK = 2048


def held_out_rooms(count: int) -> List[List[Dict]]:
    """The held-out rooms, kept as scenes: room i's blocks (with their
    ``block_min``) from ``RandomState(10_000 + i)``."""
    return [synth_rooms.room_blocks(np.random.RandomState(10_000 + i), 1,
                                    model="test", with_mins=True)
            for i in range(count)]


def eval_arm(model: nn.Module, rooms: Sequence[Sequence[Dict]],
             num_points: int, num_classes: int, device
             ) -> Tuple[Dict, List[np.ndarray]]:
    """One arm of the comparison: each room's blocks padded to
    ``num_points`` (room i's larger blocks subsampled by
    ``RandomState(i)``, so both arms label the same points; the JAX script
    draws each arm's subsample from numpy's global stream: ROADMAP.md §3,
    R12), swept by ``model`` (already on ``device``, in eval mode),
    interpolated onto the room's sampled points (k=6) and scored.
    Returns ({"miou_per_scene", "miou", "eval_points_per_sec"}, the dense
    argmax of each room).  The first room is swept once before the timer
    starts (the card's first calls build its kernels' launches and
    caches); the timer covers each room's sweep and interpolation."""
    where = next(model.parameters()).device
    if where.type != torch.device(device).type:
        raise ValueError(f"the model lives on {where}, not on {device}")
    mious, preds, eval_s, npts = [], [], 0.0, 0
    for si, room in enumerate(rooms):
        rng = np.random.RandomState(si)
        blocks = []
        for b in room:
            pb = batching.pad_block(b["xyz"], b["feats"], b["labels"],
                                    num_points, rng=rng)
            pb["block_min"] = b.get("block_min", np.zeros(3, np.float32))
            blocks.append(pb)
        dense_xyz = np.concatenate(
            [b["xyz"][b["mask"]] + b["block_min"] for b in blocks], 0)
        dense_labels = np.concatenate(
            [b["labels"][b["mask"]] for b in blocks], 0)
        if si == 0:  # warm-up outside the timer
            eval_scene_probs(model, blocks)
        t0 = time.perf_counter()
        sxyz, probs = eval_scene_probs(model, blocks)
        qprobs = interpolate_to_dense(sxyz, probs, dense_xyz, k=6)
        eval_s += time.perf_counter() - t0
        npts += len(dense_xyz)
        preds.append(qprobs.argmax(1))
        mious.append(float(scene_iou(dense_labels, preds[-1],
                                     num_classes)["miou"]))
    return ({"miou_per_scene": mious, "miou": float(np.mean(mious)),
             "eval_points_per_sec": npts / eval_s}, preds)


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--train-rooms", type=int, default=10)
    p.add_argument("--test-rooms", type=int, default=4)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--num-points", type=int, default=8192)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str,
                   default="results/eval_parity_torch.json")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = require_device(args.device)
    log = get_logger("pcs_torch.eval_parity")

    rng_np = np.random.RandomState(args.seed)
    train_blocks = synth_rooms.room_blocks(rng_np, args.train_rooms,
                                           model="train")
    rooms = held_out_rooms(args.test_rooms)

    cfg = s3dis_config(data_num_points=args.num_points,
                       optim_epoch_steps=max(
                           1, len(train_blocks) // args.batch))
    trainer = Trainer(cfg, device=device, search_chunk=SEARCH_CHUNK)

    def batches(blocks, train):
        order = (rng_np.permutation(len(blocks)) if train
                 else np.arange(len(blocks)))
        padded = [batching.pad_block(blocks[i]["xyz"], blocks[i]["feats"],
                                     blocks[i]["labels"], args.num_points,
                                     rng=rng_np) for i in order]
        return [batching.stack_blocks(padded[i:i + args.batch], args.batch,
                                      rng=rng_np, pad_masked=not train)
                for i in range(0, len(padded), args.batch)]

    # the JAX script builds its init batch here; building it keeps the
    # rooms' random stream, and so every epoch's batches, the same
    batches(train_blocks[:args.batch], False)
    state = trainer.init_state(torch.Generator().manual_seed(args.seed))
    for epoch in range(args.epochs):
        t0 = time.time()
        for b in batches(train_blocks, train=True):
            state, m = trainer.train_step(state, b)
        log.info("epoch %d loss %.4f (%.1fs)", epoch, float(m["loss"]),
                 time.time() - t0)

    # frozen weights -> two eval arms, the exact one with the windowed
    # one's state_dict
    results = {"config": vars(args)}
    if device.type == "cuda":
        results["card"] = card()
    windowed = build_model(cfg, None, device, search_chunk=SEARCH_CHUNK)
    windowed.load_state_dict(trainer.bind(state).state_dict())
    exact = build_model(cfg, None, device, windowed=False,
                        search_chunk=SEARCH_CHUNK)
    exact.load_state_dict(windowed.state_dict())
    for arm, model in (("windowed", windowed), ("exact", exact)):
        results[arm], _ = eval_arm(model.eval(), rooms, args.num_points,
                                   cfg.data.num_classes, device)
        log.info("[%s] mean scene mIoU %.4f, eval %.0f points/s", arm,
                 results[arm]["miou"], results[arm]["eval_points_per_sec"])
    results["delta_miou"] = (results["windowed"]["miou"]
                             - results["exact"]["miou"])
    results["speedup"] = (results["windowed"]["eval_points_per_sec"]
                          / results["exact"]["eval_points_per_sec"])
    log.info("EVAL PARITY delta (windowed - exact): %+.4f | windowed %.2fx "
             "faster", results["delta_miou"], results["speedup"])
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    log.info("wrote %s", args.out)
    return results


if __name__ == "__main__":
    main()
