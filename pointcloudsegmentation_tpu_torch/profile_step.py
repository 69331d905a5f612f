"""Steady-state timings of the flagship's training step and of its
pieces, and optionally a trace of 3 steps (the port's counterpart of
``scripts/profile_step.py``).

    python -m pointcloudsegmentation_tpu_torch.profile_step \
        [--logdir /tmp/pcs_trace] [--num-points 8192] [--batch 4]

Builds the flagship ``pointnet_s3dis`` (bf16 compute, weights from
``torch.Generator`` seed 0, caps N/2 and N/8) and one batch of ``toy``
room blocks (seed 0), then prints ``utils.profiling.time_fn`` rows
(ms/call: median, min, max, mean) for:

- the full training step on the batch already on the device;
- the step on the host batch (its copy to the device included);
- the Morton sort and the voxel pyramid of one block (what the model
  runs before its encoder; the JAX script times the pyramid of the
  unsorted block, whose level 0 then takes the global search, a path no
  model's forward takes);
- one block's encoder forward on that pyramid (the flagship's encoder,
  with the state's weights, under ``torch.no_grad``).

With ``--logdir`` it also traces 3 steps through
``utils.profiling.trace`` (a Chrome trace that Perfetto reads; summarise
it with ``trace_step --analyze-only --logdir``).  It runs on the card
unless ``--device cpu`` is given; on the card the first line names the
card and its power limit.
"""
from __future__ import annotations

import argparse
from typing import Dict

import torch

from .config import require_device, s3dis_config
from .data import toy
from .data.provider import to_device
from .ops import hierarchy as hier
from .ops import morton
from .train.loop import Trainer
from .utils import profiling
from .utils.timing import card

TRACED_STEPS = 3


def main(argv=None) -> Dict[str, Dict[str, float]]:
    """Prints the rows; returns them by name."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--logdir", default=None)
    p.add_argument("--num-points", type=int, default=8192)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--warmup", type=int, default=2,
                   help="untimed calls before each row")
    p.add_argument("--iters", type=int, default=10,
                   help="timed calls of each row")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = require_device(args.device)
    if device.type == "cuda":
        print(f"[profile_step] {card()}", flush=True)
    n = args.num_points
    cfg = s3dis_config(data_num_points=n, data_caps=(n // 2, n // 8),
                       data_feat_dim=12)
    tr = Trainer(cfg, device=device, search_chunk=2048)
    batch = next(toy.toy_batches(1, batch_size=args.batch, num_points=n,
                                 kind="room"))
    holder = {"state": tr.init_state(torch.Generator().manual_seed(0))}
    dev_batch = to_device(batch, device)

    def step(b):
        holder["state"], m = tr.train_step(holder["state"], b)
        return m["loss"]

    timed = dict(warmup=args.warmup, iters=args.iters)
    step(dev_batch)
    rows = {"full train step": profiling.time_fn(step, dev_batch, **timed),
            "step w/ host batch": profiling.time_fn(step, batch, **timed)}
    for name in rows:
        print(f"{name}:", rows[name], flush=True)

    d = cfg.data
    xyz, feats, mask = (dev_batch[k][0] for k in ("xyz", "feats", "mask"))

    def pyramid(x, f, mk):
        xs, ms, _, fs = morton.sort_block(x, mk, d.voxel_sizes[0] / 4.0,
                                          d.block_size, f)
        return hier.build_pyramid(xs, ms, d.voxel_sizes, d.caps,
                                  d.block_size, morton_sorted=True), fs

    rows["pyramid"] = profiling.time_fn(
        lambda *a: pyramid(*a)[0].levels[-1].xyz, xyz, feats, mask, **timed)
    print("pyramid:", rows["pyramid"], flush=True)
    pyr, sfeats = pyramid(xyz, feats, mask)
    enc = tr.bind(holder["state"]).encoder
    with torch.no_grad():
        rows["encoder fwd (1 block)"] = profiling.time_fn(enc, pyr, sfeats,
                                                          **timed)
    print("encoder fwd (1 block):", rows["encoder fwd (1 block)"],
          flush=True)

    if args.logdir:
        with profiling.trace(args.logdir, cuda=device.type == "cuda"):
            for _ in range(TRACED_STEPS):
                step(dev_batch)
        print("trace written to", args.logdir)
    return rows


if __name__ == "__main__":
    main()
