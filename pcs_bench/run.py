"""Run one cell of the benchmark on one card and print its result line.

    python3 -m pcs_bench.run --workload pointnet_s3dis.train_dense \
        --seed 7 --seconds 30 --trace 0

from the root of a checkout.  Set-up (imports, kernel builds on the first
run in a checkout, weights and inputs from ``--seed``, the cell's first
steps) counts as ``setup_s``; the window runs for ``--seconds``; with
``--trace 1`` a profiled stretch follows and the per-layer metrics are
reported in place of the end-to-end ones.  The run then frees the program,
compares its outputs with the plain reference and prints the compared
numbers beside their limits on standard error and the result as the last
line of standard output.  It exits with 1, printing no result, without a
card, or if JAX or the JAX package is loaded."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from . import harness

    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    cell = harness.Cell(bench, args.workload)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _log(f"[pcs_bench] {args.workload} needs {chips} CUDA device(s); "
             f"found {torch.cuda.device_count()}")
        return 1
    _log(f"[pcs_bench] {torch.cuda.get_device_name(0)}, torch "
         f"{torch.__version__}, CUDA {torch.version.cuda}")
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda:0", T_START, log=_log)
    bad = harness.forbidden_modules()
    if bad:
        _log(f"[pcs_bench] loaded in the measuring process: {bad}")
        return 1
    harness.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
