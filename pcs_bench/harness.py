"""The harness: finds a cell's configuration, traffic mix, limits and
per-layer metric readers by name, runs set-up, the measured window, the
traced stretch and the check, and builds the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own under this directory; ``BENCHMARK.json`` at the root names
them.  A traffic file names its ``entry``, a module of ``drivers/``."""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time
from typing import Dict, List

import torch

from . import compare, spans, trace
from .counts import peaks

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names that may not be loaded in the process that prints
# the result
FORBIDDEN = ("jax", "jaxlib", "flax", "pointcloudsegmentation_tpu")


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One entry of ``workloads`` with everything it names."""

    def __init__(self, bench: Dict, workload: str):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r}; BENCHMARK.json has "
                           f"{sorted(cells)}")
        self.entry = cells[workload]
        self.name = workload
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = load_json(os.path.join(
            ROOT, configs[self.entry["config"]]["file"]))
        self.traffic = load_json(os.path.join(
            HERE, "traffic", self.entry["traffic"] + ".json"))
        self.limits = load_json(os.path.join(HERE, "limits",
                                             workload + ".json"))
        self.end_to_end = [m for m in bench["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        self.per_layer = [m for m in bench["per_layer"]
                          if workload in m.get("workloads", [workload])]


def reader(name: str):
    """The per-layer metric reader ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "pcs_bench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(entry: str):
    """The class in ``drivers/<entry>.py`` that runs a traffic file's
    ``entry``."""
    return importlib.import_module(f"pcs_bench.drivers.{entry}").Driver


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def json_safe(x):
    """JSON has no inf or nan: such a number is given as a string."""
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    if isinstance(x, dict):
        return {k: json_safe(v) for k, v in x.items()}
    if isinstance(x, list):
        return [json_safe(v) for v in x]
    return x


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device, t_start: float, log=print) -> Dict:
    """Set-up, window, (traced stretch), check; returns the result object
    (without printing it)."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    drv = driver(cell.traffic["entry"])(cell.config, cell.traffic, seed,
                                        device)
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    log(f"[pcs_bench] {cell.name} seed {seed}: set-up {setup_s:.3f} s")

    # the window: closed loop until the time is up, then one host read
    units = 0
    t0 = time.perf_counter()
    while True:
        drv.unit()
        units += 1
        if time.perf_counter() - t0 >= seconds:
            break
    drv.close()
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    points_per_s = units * drv.points_per_unit / window_s
    log(f"[pcs_bench] window {window_s:.4f} s, {units} {drv.unit_name}s, "
        f"{points_per_s:.1f} points/s, peak {peak / 2 ** 30:.4f} GiB")

    result: Dict = {"correct": False, "attempted": units,
                    "failed": drv.failed(), "metrics": {}}
    dev_info = {"platform": "gpu" if on_card else device.type,
                "kind": (torch.cuda.get_device_name(device) if on_card
                         else device.type),
                "count": 1, "memory_peak_bytes": int(peak)}
    e2e = {cell.traffic["rate_metric"]: points_per_s,
           "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
    if not traced:
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                            "unit": m["unit"]}
    else:
        ctx = traced_stretch(drv, cell, units, window_s, device)
        dev_info["busy_s"] = ctx["trace"]["busy_s"]
        dev_info["window_s"] = ctx["trace"]["window_s"]
        for m in cell.per_layer:
            v = reader(m["name"]).read(ctx)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v,
                                                "unit": m["unit"]}
        result["breakdown"] = {"device_ops": ctx["trace"]["device_ops"],
                               "idle_gaps": ctx["trace"]["idle_gaps"]}
    result["device"] = dev_info

    drv.free()
    ok, checks = compare.judge(drv.check(), cell.limits)
    result["correct"] = ok and result["failed"] == 0
    result["checks"] = checks
    return json_safe(result)


def traced_stretch(drv, cell: Cell, units: int, window_s: float,
                   device) -> Dict:
    """The profiled stretch after the window (``trace_units`` units and one
    host read), and what the per-layer readers read: its trace summary,
    its attribution to the port's spans (``spans.attribute``), the window's
    units and seconds, the block's counted work and the card's peaks."""
    n = cell.traffic["trace_units"]
    st = trace.stretch(drv, n)
    ev, t0, t1 = st["events"], st["t0_us"], st["t1_us"]
    return {"trace": trace.summarise(ev, t0, t1),
            "spans": spans.attribute(ev, t0, t1),
            "traced_units": n, "traced_blocks": n * drv.blocks_per_unit,
            "window_s": window_s, "window_blocks": units * drv.blocks_per_unit,
            "work": drv.block_work(),
            "peaks": peaks.of(device)}


def report(result: Dict) -> None:
    """The compared numbers, each beside its limit, as the last lines of
    standard error; then the result as the last line of standard
    output."""
    for name, c in result["checks"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    ordered = {k: result[k] for k in result if k != "checks"}
    ordered["checks"] = result["checks"]
    print(json.dumps(ordered), flush=True)
