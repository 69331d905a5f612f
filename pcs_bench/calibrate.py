"""The readings that a cell's limits are set from, at the cell's own size:
the program against the reference on many seeds (the lower reading), the
lower-precision control in the program's place (the upper reading), and
for a training cell the program with half of each batch left out.

    python3 -m pcs_bench.calibrate --workload pointnet_s3dis.train_dense \
        --seeds 101-112 --control 101-103 --fault 101-103

One process reads every seed, so the kernels build once.  Each seed prints
one JSON line {"seed", "program", "control", "half_batch"} (the last two
where asked).  The benchmark's own runs do not run this."""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import Dict, List

import numpy as np
import torch

from . import compare, harness


def _ints(spec: str) -> List[int]:
    out = []
    for part in spec.split(","):
        if "-" in part:
            a, b = part.split("-")
            out += range(int(a), int(b) + 1)
        elif part:
            out.append(int(part))
    return out


def look(drv, prog: Dict, ref: Dict) -> Dict:
    """Where a training cell's gaps come from: both sides' losses step by
    step, and the leaves whose first-gradient norms differ most."""
    a = compare.leaf_norms(drv.leaves, prog["g1"])
    b = compare.leaf_norms(drv.leaves, ref["g1"])
    rel = np.abs(a - b) / np.maximum(b, np.median(b))
    worst = np.argsort(-rel)[:3]
    return {"losses": prog["losses"], "ref_losses": ref["losses"],
            "grad_gap_median_leaf": float(np.median(rel)),
            "grad_worst": [[drv.leaves[i].key, float(rel[i]), float(b[i]),
                            float(np.median(b))] for i in worst]}


def read_seed(cell: harness.Cell, seed: int, device, control: bool,
              fault: bool, units: int) -> Dict:
    drv = harness.driver(cell.traffic["entry"])(cell.config, cell.traffic,
                                                seed, device)
    out: Dict = {"seed": seed}
    if cell.traffic["entry"] == "train_step":
        half = None
        if fault:
            half = drv.first_steps([{k: v[:v.shape[0] // 2] for k, v in
                                     b.items()} for b in drv.batches])
        drv.free()
        ref = drv.follow("float32")
        out["program"] = drv.readings(drv.prog, ref)
        out["look"] = look(drv, drv.prog, ref)
        if half is not None:
            out["half_batch"] = drv.readings(half, ref)
        if control:
            out["control"] = drv.readings(drv.follow("fp8"), ref)
    else:
        drv.traffic = dict(drv.traffic, sample_share=1.0)
        for _ in range(units):
            drv.unit()
        drv.close()
        drv.free()
        ref = drv.reference_logp("float32")
        out["program"] = drv.readings(drv.kept, ref)
        if control:
            ctl = [np.exp(lp) for lp in drv.reference_logp("fp8")]
            out["control"] = drv.readings(list(enumerate(ctl)), ref)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="e.g. 101-112")
    p.add_argument("--control", default="", help="seeds that also read the "
                   "control")
    p.add_argument("--fault", default="", help="seeds that also read the "
                   "half-batch fault (training cells)")
    p.add_argument("--units", type=int, default=8,
                   help="scenes a labelling seed runs")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate runs on a card", file=sys.stderr)
        return 1
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        card = torch.cuda.get_device_name(0)
    print(f"# {card}", flush=True)
    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    cell = harness.Cell(bench, args.workload)
    control, fault = set(_ints(args.control)), set(_ints(args.fault))
    for seed in _ints(args.seeds):
        out = read_seed(cell, seed, "cuda:0", seed in control,
                        seed in fault, args.units)
        print(json.dumps(harness.json_safe(out)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
