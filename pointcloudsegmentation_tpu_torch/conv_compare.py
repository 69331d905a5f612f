"""Conv-operator comparison harness (the port's counterpart of
``scripts/conv_compare.py``; reference: conv_compare.py + conv_compare.sh,
which train each conv flavor on one S3DIS block-set and log acc/IoU per
epoch, SURVEY.md §2.9).

Each registered conv flavor trains at its full width on the same seeded
``toy`` room blocks for a few epochs, each epoch a training pass and a
test pass over the same batches, and logs loss/mIoU/oAcc per epoch.

    python -m pointcloudsegmentation_tpu_torch.conv_compare \
        --epochs 3 --steps 25 --batch 2 --num-points 2048 \
        --out results/conv_compare_torch.json

The JSON maps each flavor to its records, as the JAX script's does.  It
runs on the card unless ``--device cpu`` is given; on the card the log
names the card and its power limit first.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from .config import require_device, s3dis_config
from .data import toy
from .train.loop import Trainer
from .utils.logging import get_logger
from .utils.timing import card

# The reference benches ~8 conv flavors (conv_compare.sh:23-29: pointnet /
# concat ECD / anchor / mlp_anchor / the pgnet family); each key here maps
# to the registry's equivalent operator.
FLAVORS = ["pointnet_s3dis", "ecd_s3dis", "pgnet_v8", "gpn_seg",
           "template_pointnet", "template_anchor", "template_mlp_anchor",
           "template_diffusion_anchor",
           # reference ablation span: no-growth 20-layer baseline, deconv
           # decoder, embed-without-dilation, PointNet++-style baseline
           # (model_pointnet.py:106-929, model_pgnet.py:1133-1223)
           "pointnet_baseline20", "pointnet_concat10_deconv",
           "pointnet_embed_only", "pointnet2_s3dis"]


def run_flavor(model: str, args, log, device="cuda"):
    """Train ``model`` ``args.epochs`` epochs of ``args.steps`` batches of
    ``args.batch`` blocks; one record per epoch."""
    n = args.num_points
    cfg = s3dis_config(model=model, data_num_points=n,
                       data_caps=(n // 2, n // 8),
                       optim_epoch_steps=args.steps)
    trainer = Trainer(cfg, device=device, search_chunk=min(1024, n))
    batches = list(toy.toy_batches(args.steps, args.batch, num_points=n,
                                   kind="room"))
    state = trainer.init_state(torch.Generator().manual_seed(0))
    results = []
    for epoch in range(args.epochs):
        t0 = time.time()
        state, _ = trainer.run_epoch(state, batches, train=True)
        state, res = trainer.run_epoch(state, batches, train=False)
        results.append({"epoch": epoch, "loss": float(res.get("loss", 0)),
                        "miou": float(res["miou"]),
                        "oacc": float(res["oacc"]),
                        "epoch_sec": time.time() - t0})
        log.info("%s epoch %d: loss %.4f mIoU %.4f oAcc %.4f (%.1fs)",
                 model, epoch, results[-1]["loss"], results[-1]["miou"],
                 results[-1]["oacc"], results[-1]["epoch_sec"])
    return results


def main(argv=None):
    """Trains every flavor asked for; returns {flavor: records}."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--steps", type=int, default=25)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--num-points", type=int, default=2048)
    p.add_argument("--flavors", nargs="*", default=FLAVORS)
    p.add_argument("--out", type=str,
                   default="results/conv_compare_torch.json")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = require_device(args.device)
    log = get_logger("pcs_torch.conv_compare")

    if device.type == "cuda":
        log.info("card: %s", card())
    all_results = {}
    for flavor in args.flavors:
        log.info("=== %s ===", flavor)
        all_results[flavor] = run_flavor(flavor, args, log, device)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(all_results, f, indent=2)
    log.info("wrote %s", args.out)
    return all_results


if __name__ == "__main__":
    main()
