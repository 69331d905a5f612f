"""Trace the flagship's training step and print the kernels that take the
most device time (the port's counterpart of ``scripts/trace_step.py``;
the Chrome-timeline analog of the reference's RunOptions.FULL_TRACE,
model_pooling.py:607-619).

    python -m pointcloudsegmentation_tpu_torch.trace_step \
        [--logdir DIR] [--top 40] [--analyze-only]

``capture`` trains the flagship ``pointnet_s3dis`` (bf16 compute, weights
from ``torch.Generator`` seed 0, caps N/2 and N/8) on one batch of 4
``toy`` room blocks of 8192 points (seed 0): 3 warm-up steps, then 3
steps under ``utils.profiling.trace``, which writes a Chrome trace into
``--logdir`` (default ``pcs_trace_step`` in the temporary directory).
``analyze`` reads the newest ``*.pt.trace.json`` there and sums the
device kernels' time by kernel name (kernels do not nest, so their time
is their self time); it prints the total, then the ``--top`` names with
their share, calls and time.  A trace without device kernels
(one taken on the CPU) has its CPU operators summed by self time instead:
each operator's time less that of the operators it called.  It runs on
the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

from .config import require_device, s3dis_config
from .data import toy
from .data.provider import to_device
from .train.loop import Trainer
from .utils import profiling
from .utils.timing import card

STEPS = 3


def capture(logdir: str, num_points: int = 8192, batch: int = 4,
            device="cuda") -> None:
    n = num_points
    cfg = s3dis_config(data_num_points=n, data_caps=(n // 2, n // 8),
                       data_feat_dim=12)
    tr = Trainer(cfg, device=device, search_chunk=2048)
    b = to_device(next(toy.toy_batches(1, batch_size=batch, num_points=n,
                                       kind="room")),
                  device)
    state = tr.init_state(torch.Generator().manual_seed(0))
    for _ in range(STEPS):
        state, m = tr.train_step(state, b)
    float(m["loss"])
    with profiling.trace(logdir, cuda=torch.device(device).type == "cuda"):
        for _ in range(STEPS):
            state, m = tr.train_step(state, b)
        float(m["loss"])


def _cpu_self_times(events: List[Dict]) -> List[Tuple[str, int, float]]:
    """(name, 1, self microseconds) of each CPU operator: its duration
    less the durations of the operators directly inside it on its
    thread."""
    by_thread = defaultdict(list)
    for e in events:
        by_thread[(e["pid"], e["tid"])].append(e)
    rows = []
    for evs in by_thread.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []      # [event, time of its direct children]
        for e in evs:
            while stack and (e["ts"] >= stack[-1][0]["ts"]
                             + stack[-1][0]["dur"]):
                done, inner = stack.pop()
                rows.append((done["name"], 1, done["dur"] - inner))
            if stack:
                stack[-1][1] += e["dur"]
            stack.append([e, 0.0])
        rows.extend((done["name"], 1, done["dur"] - inner)
                    for done, inner in stack)
    return rows


def analyze(logdir: str, top: int, steps: int = STEPS) -> Dict:
    """Sum the newest trace's device-kernel time by name and print the
    total and the ``top`` names.  Returns {"what": "kernel" or "cpu_op",
    "total_ms": per step, "rows": [(name, calls per step, ms per step,
    share of the total)], the most time first}."""
    files = glob.glob(os.path.join(logdir, "**", "*.pt.trace.json"),
                      recursive=True)
    if not files:
        raise FileNotFoundError(f"no *.pt.trace.json under {logdir}")
    path = max(files, key=os.path.getmtime)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    kernels = [(e["name"], 1, e["dur"]) for e in events
               if e.get("cat") == "kernel"]
    what = "kernel" if kernels else "cpu_op"
    rows = kernels or _cpu_self_times(
        [e for e in events if e.get("cat") == "cpu_op"])
    total_ms, rows = profiling.by_name(rows, steps)
    print(f"[{os.path.basename(path)}] {what} self time: "
          f"{total_ms:.3f} ms a step over {sum(r[1] for r in rows):.1f} "
          f"{what}s a step ({steps} steps)")
    for name, n, ms, share in rows[:top]:
        print(f" {ms:9.3f} ms  {100 * share:5.1f}%  {n:7.1f}  {name[:110]}")
    return {"what": what, "total_ms": total_ms, "rows": rows}


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--logdir", default=os.path.join(tempfile.gettempdir(),
                                                    "pcs_trace_step"))
    p.add_argument("--top", type=int, default=40)
    p.add_argument("--analyze-only", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if not args.analyze_only:
        device = require_device(args.device)
        if device.type == "cuda":
            print(f"[trace_step] {card()}", flush=True)
        capture(args.logdir, device=device)
    return analyze(args.logdir, args.top)


if __name__ == "__main__":
    main()
