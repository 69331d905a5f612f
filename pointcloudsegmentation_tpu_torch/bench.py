"""Flagship S3DIS training and eval throughput per card, with the step's
FLOP count and MFU (the port's counterpart of the repo-root ``bench.py``).

    python -m pointcloudsegmentation_tpu_torch.bench [--points 8192] \
        [--batch 4] [--chunk 2048] [--device cuda]

Train: ``pointnet_s3dis`` at full width (caps 4096/1024, 12 features, bf16
compute, weights from ``torch.Generator`` seed 0, search chunk ``--chunk``)
on two batches of ``--batch`` synthetic rooms of ``--points`` points
(``toy.toy_batches``, seed 0), moved to the device once before any
timing.  ``WARMUP`` steps on alternating batches, one host read, then 3
chains of ``ITERS`` steps, each ending in one host read; the median
chain's seconds per step give the valid points per second.

FLOPs and MFU: ``Trainer.step_flops`` of the first batch (matmul-family
ops of the per-block forward and backward, times the blocks; see its
docstring for why it cannot be set beside the TPU's XLA count) over the
median step seconds and the card's dense bf16 peak, looked up by
``torch.cuda.get_device_name()`` in ``PEAK_FLOPS``; a card not in the
table, or a device that is no card, raises.

Eval: 8 synthetic rooms (``eval_scene``) swept by ``eval_scene_probs``,
their probabilities interpolated onto a cloud 4 times as dense
(``interpolate_to_dense``, k=6, the native host arm); one warm sweep
(which also builds the native library, where ``bench.py`` warmed the
block sweep alone), then the median of 3 sweeps gives dense points per
second.

Earlier lines print the card's name and power limit, the chains' and the
sweeps' seconds and the peak device memory.  The last line is one JSON
object with the keys of the repo-root ``bench.py``: ``metric``, ``value``,
``unit``, ``vs_baseline`` (against an estimated 8e4 points/s of the
TF-CUDA reference on one V100, ``BASELINE.md``), ``mfu`` (4 significant
figures), ``flops_per_step`` and ``eval_points_per_sec_per_chip``.  A
failure raises; nothing is reported as 0 in its place."""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from .config import require_device, s3dis_config
from .data import toy
from .data.provider import to_device
from .eval.interpolate import eval_scene_probs, interpolate_to_dense
from .train.loop import Trainer
from .utils.timing import card

BASELINE_POINTS_PER_SEC = 8.0e4   # estimated TF-CUDA reference, 1x V100
# dense bf16 FLOP/s by device name: the H100 SXM data sheet, 700 W
PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": 989e12}
CAPS = (4096, 1024)
FEAT_DIM = 12
NUM_CLASSES = 13
WARMUP = 3          # untimed steps before the chains
ITERS = 20          # steps per chain
CHAINS = SWEEPS = 3
EVAL_BLOCKS = 8
DENSE_COPIES = 4
KNN = 6


def peak_flops(device: torch.device) -> float:
    """The dense bf16 peak of the card ``device`` from ``PEAK_FLOPS``,
    keyed by ``torch.cuda.get_device_name``."""
    name = torch.cuda.get_device_name(device)
    if name not in PEAK_FLOPS:
        raise KeyError(f"no peak FLOP/s for {name!r}: add its dense bf16 "
                       f"rate to bench.PEAK_FLOPS")
    return PEAK_FLOPS[name]


def eval_scene(num_points: int, rng: np.random.RandomState
               ) -> Tuple[List[Dict], np.ndarray]:
    """The eval scene of the repo-root ``bench.py`` (its lines 107-129):
    ``EVAL_BLOCKS`` synthetic rooms of ``num_points`` points drawn from
    ``rng``, every point valid, block i at ``block_min`` = (3i, 0, 0); then
    the dense cloud, ``DENSE_COPIES`` copies of each block's points
    jittered by U(-0.05, 0.05) and shifted by its ``block_min`` (queries
    near the sampled surfaces, as in S3DIS).  Returns (blocks of numpy
    arrays, dense [EVAL_BLOCKS * DENSE_COPIES * num_points, 3] float32)."""
    blocks = []
    for i in range(EVAL_BLOCKS):
        b = toy.synthetic_room_block(rng, n=num_points,
                                     num_classes=NUM_CLASSES,
                                     feat_dim=FEAT_DIM)
        blocks.append({"xyz": b["xyz"], "feats": b["feats"],
                       "mask": np.ones(num_points, bool),
                       "block_min": np.array([3.0 * i, 0, 0], np.float32)})
    dense = np.concatenate(
        [np.repeat(b["xyz"], DENSE_COPIES, axis=0)
         + rng.uniform(-0.05, 0.05, (DENSE_COPIES * num_points, 3)
                       ).astype(np.float32)
         + b["block_min"][None, :] for b in blocks], axis=0)
    return blocks, dense.astype(np.float32)


def _median(xs: List[float]) -> float:
    return sorted(xs)[len(xs) // 2]


def _seconds(xs: List[float]) -> str:
    return ", ".join(f"{x:.4f}" for x in xs)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--points", type=int, default=8192,
                   help="points per block")
    p.add_argument("--batch", type=int, default=4, help="blocks per step")
    p.add_argument("--chunk", type=int, default=2048,
                   help="the search's query chunk")
    p.add_argument("--device", type=str, default="cuda",
                   help="a card whose peak is in PEAK_FLOPS (default cuda); "
                        "a CPU run is for tests, which patch peak_flops")
    return p.parse_args(argv)


def main(argv=None) -> Dict:
    """Prints the lines; returns the final line's object."""
    args = parse_args(argv)
    device = require_device(args.device)
    peak = peak_flops(device)
    on_card = device.type == "cuda"
    if on_card:
        print(f"[bench] {card()}", flush=True)
        torch.cuda.reset_peak_memory_stats(device)

    cfg = s3dis_config(data_num_points=args.points, data_caps=CAPS,
                       data_feat_dim=FEAT_DIM)
    trainer = Trainer(cfg, device, search_chunk=args.chunk)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    # on the device before any timing: a real input pipeline prefetches
    # (data/provider.py), so a step is not billed its host-to-device copy
    batches = [to_device(b, device) for b in toy.toy_batches(
        2, batch_size=args.batch, num_points=args.points, kind="room",
        num_classes=NUM_CLASSES, feat_dim=FEAT_DIM)]
    print(f"[bench] {cfg.model} {cfg.compute_dtype}: {trainer.num_params} "
          f"params, {args.batch} blocks x {args.points} points a step, "
          f"search chunk {args.chunk}, on {device}", flush=True)
    for i in range(WARMUP):
        state, m = trainer.train_step(state, batches[i % 2])
    float(m["loss"])

    # chains of steps with one host read at the end: a training loop does
    # not synchronise per step
    valid = int(batches[0]["mask"].sum())
    chains = []
    for _ in range(CHAINS):
        t0 = time.perf_counter()
        for i in range(ITERS):
            state, m = trainer.train_step(state, batches[i % 2])
        float(m["loss"])
        chains.append((time.perf_counter() - t0) / ITERS)
    dt = _median(chains)
    pps = valid / dt
    print(f"[bench] train step s ({CHAINS} chains of {ITERS}): "
          f"{_seconds(chains)}; median: {valid} valid points / {dt:.4f} s "
          f"= {pps:.1f} points/s", flush=True)

    flops = trainer.step_flops(state, batches[0])
    mfu = flops / dt / peak
    print(f"[bench] step FLOPs {flops:.6e} (matmul-family ops); peak "
          f"{peak:.4g} FLOP/s; mfu {mfu:.4g}", flush=True)

    # eval: block sweep -> probabilities -> dense interpolation
    blocks, dense = eval_scene(args.points, np.random.RandomState(0))
    blocks = [dict(b, **{k: torch.from_numpy(b[k]).to(device)
                         for k in ("xyz", "feats", "mask")}) for b in blocks]
    model = trainer.bind(state)

    def sweep():
        sxyz, probs = eval_scene_probs(model, blocks)
        return interpolate_to_dense(sxyz, probs, dense, k=KNN)

    sweep()     # warm: also builds the native host library at first use
    sweeps = []
    for _ in range(SWEEPS):
        t0 = time.perf_counter()
        sweep()
        sweeps.append(time.perf_counter() - t0)
    eval_pps = len(dense) / _median(sweeps)
    print(f"[bench] eval sweep s ({SWEEPS}): {_seconds(sweeps)}; median: "
          f"{len(dense)} dense points / {_median(sweeps):.4f} s = "
          f"{eval_pps:.1f} points/s", flush=True)
    if on_card:
        print(f"[bench] peak device memory "
              f"{torch.cuda.max_memory_allocated(device) / 2 ** 30:.3f} GiB",
              flush=True)

    out = {
        "metric": "s3dis_train_points_per_sec_per_chip",
        "value": round(pps, 1),
        "unit": "points/s",
        "vs_baseline": round(pps / BASELINE_POINTS_PER_SEC, 3),
        "mfu": float(f"{mfu:.4g}"),
        "flops_per_step": flops,
        "eval_points_per_sec_per_chip": round(eval_pps, 1),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
