"""Windowed-vs-exact mIoU parity A/B of the port (``scripts/parity_ab.py``):
train the same model twice on the same synthetic S3DIS-like rooms of
``data/synth_rooms.py``, put through the real offline prep
(``s3dis.prepare_room``), once with the windowed neighbor search (the
training default) and once with the exact global search
(``Trainer(windowed=False)``), and record the test mIoU after every
epoch.  Both arms share the blocks, the init seed and the batch order.
The result holds each arm's curve and ``delta_final_miou`` /
``delta_best_miou`` (windowed - exact); the parity target is |delta| <=
0.03 mIoU, the "stricter +/-0.03 target" of ``BASELINE.md``.

Usage (the recorded configuration; a few minutes an arm on the card):
  python -m pointcloudsegmentation_tpu_torch.parity_ab --train-rooms 10 \
      --test-rooms 4 --epochs 12 --batch 4 --num-points 8192 --seed 0 \
      --arms windowed exact --config s3dis --out results/parity_ab_torch.json

``--arms`` picks the arms (default both); ``--hard`` trains and tests on
the hard synthetic regime (scanner density gradient, occlusion, speckle,
rarer minority classes, 2-room scenes).  ``--config scannet`` runs the
ScanNet recipe on the same rooms: no input colors, labels shifted up by
one with 3% set to 0, the ignored label.  It runs on the card unless
``--device cpu`` is given; on the card the JSON carries the card's name
and power limit.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from .config import require_device, s3dis_config, scannet_config
from .data import batching, synth_rooms
from .train.loop import Trainer
from .train.metrics import MetricAccumulator
from .utils.logging import get_logger
from .utils.timing import card

ARMS = ("windowed", "exact")


def make_batches(blocks, num_points, batch, rng, train):
    """Pad blocks and group into [B, ...] batches (train: shuffled)."""
    order = rng.permutation(len(blocks)) if train else np.arange(len(blocks))
    padded = [batching.pad_block(blocks[i]["xyz"], blocks[i]["feats"],
                                 blocks[i]["labels"], num_points, rng=rng)
              for i in order]
    out = []
    for i in range(0, len(padded), batch):
        out.append(batching.stack_blocks(padded[i:i + batch], batch,
                                         rng=rng, pad_masked=not train))
    return out


def scannetify(blocks, rng):
    """Map synthetic S3DIS-like blocks onto the ScanNet training contract
    (train_gpn_scannet_new.py:66-88): NO input colors (feat_dim 0), labels
    shifted up by 1 with label 0 = unannotated/ignored (3% of points)."""
    out = []
    for b in blocks:
        lbl = b["labels"].astype(np.int32) + 1
        lbl[rng.rand(len(lbl)) < 0.03] = 0
        out.append({"xyz": b["xyz"],
                    "feats": np.zeros((len(lbl), 0), np.float32),
                    "labels": lbl})
    return out


def make_cfg(args, steps):
    """The JAX script's config: the preset's voxel caps at every point
    count."""
    if args.config == "scannet":
        # synthetic rooms carry 13 classes; keep ScanNet's ignore-label-0
        # + shift semantics but size the head to the data
        return scannet_config(model=args.model or "pointnet_scannet",
                              data_num_points=args.num_points,
                              data_num_classes=13, optim_epoch_steps=steps)
    return s3dis_config(model=args.model or "pointnet_s3dis",
                        data_num_points=args.num_points,
                        optim_epoch_steps=steps)


def make_blocks(args):
    """The train rooms (seed ``args.seed``) and test rooms (seed 10,000)
    as blocks; ``--hard``: the hard regime in 2-room scenes."""
    gen_kw = dict(hard=True, rooms_per_scene=2) if args.hard else {}
    rng = np.random.RandomState(args.seed)
    train_blocks = synth_rooms.room_blocks(rng, args.train_rooms,
                                           model="train", **gen_kw)
    test_blocks = synth_rooms.room_blocks(np.random.RandomState(10_000),
                                          args.test_rooms, model="test",
                                          **gen_kw)
    if args.config == "scannet":
        train_blocks = scannetify(train_blocks, rng)
        test_blocks = scannetify(test_blocks, np.random.RandomState(10_001))
    return train_blocks, test_blocks


def run_arm(arm, train_blocks, test_blocks, args, device, log):
    """Train one arm from the seed's init; ``exact``: the global search at
    every level."""
    steps = max(1, len(train_blocks) // args.batch)
    cfg = make_cfg(args, steps)
    trainer = Trainer(cfg, device=device,
                      search_chunk=min(2048, args.num_points),
                      windowed=arm == "windowed")
    nprng = np.random.RandomState(args.seed)
    test_batches = make_batches(test_blocks, args.num_points, args.batch,
                                np.random.RandomState(0), train=False)
    state = trainer.init_state(torch.Generator().manual_seed(args.seed))
    curve = []
    best = 0.0
    for epoch in range(args.epochs):
        t0 = time.time()
        batches = make_batches(train_blocks, args.num_points, args.batch,
                               nprng, train=True)
        for b in batches:
            state, m = trainer.train_step(state, b)
        loss = float(m["loss"])
        t_train = time.time() - t0
        acc = MetricAccumulator(cfg.data.num_classes)
        for b in test_batches:
            _, m = trainer.eval_step(state, b)
            acc.update(m["cm"], m["loss"])
        res = acc.result()
        curve.append({"epoch": epoch, "miou": float(res["miou"]),
                      "oacc": float(res["oacc"]), "last_train_loss": loss,
                      "train_s": t_train, "epoch_s": time.time() - t0})
        best = max(best, float(res["miou"]))
        log.info("[%s] epoch %d: test mIoU %.4f oAcc %.4f (%.1fs, train "
                 "%.1fs)", arm, epoch, res["miou"], res["oacc"],
                 time.time() - t0, t_train)
    return {"curve": curve, "final_miou": curve[-1]["miou"],
            "best_miou": best, "steps_per_epoch": len(batches)}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--train-rooms", type=int, default=10)
    p.add_argument("--test-rooms", type=int, default=4)
    p.add_argument("--epochs", type=int, default=12)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--num-points", type=int, default=8192)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--model", type=str, default=None,
                   help="registry key; default: the config's flagship")
    p.add_argument("--config", choices=["s3dis", "scannet"],
                   default="s3dis")
    p.add_argument("--arms", nargs="*", choices=ARMS, default=list(ARMS))
    p.add_argument("--hard", action="store_true",
                   help="hard synthetic regime: scanner density gradient, "
                        "occlusion dropout, speckle, rarer minority "
                        "classes, 2-room scenes (blocks straddle rooms)")
    p.add_argument("--out", type=str, default="results/parity_ab_torch.json")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = require_device(args.device)
    log = get_logger("pcs_torch.parity_ab")

    t0 = time.time()
    train_blocks, test_blocks = make_blocks(args)
    log.info("blocks: %d train / %d test; median points %d (%.1fs)",
             len(train_blocks), len(test_blocks),
             int(np.median([len(b["xyz"]) for b in train_blocks])),
             time.time() - t0)

    results = {"config": vars(args), "blocks": [len(train_blocks),
                                                len(test_blocks)]}
    if device.type == "cuda":
        results["card"] = card()
    for arm in args.arms:
        log.info("=== arm: %s ===", arm)
        results[arm] = run_arm(arm, train_blocks, test_blocks, args,
                               device, log)
        log.info("[%s] best mIoU %.4f final %.4f", arm,
                 results[arm]["best_miou"], results[arm]["final_miou"])
    if "windowed" in results and "exact" in results:
        delta = (results["windowed"]["final_miou"]
                 - results["exact"]["final_miou"])
        results["delta_final_miou"] = delta
        results["delta_best_miou"] = (results["windowed"]["best_miou"]
                                      - results["exact"]["best_miou"])
        log.info("PARITY delta (windowed - exact): final %+.4f best %+.4f",
                 delta, results["delta_best_miou"])
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    log.info("wrote %s", args.out)
    return results


if __name__ == "__main__":
    main()
