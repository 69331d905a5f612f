"""The port's layer spans in a profiled stretch: each device interval, each
idle gap and each host sync put down to the innermost of the port's four
spans, on the trace's own clock.

The port opens ``pcs.forward`` (a block's forward), ``pcs.encoder`` (the
encoder, inside it), ``pcs.search`` (a stage's neighbourhood search,
inside the encoder) and ``pcs.backward`` (a block's backward) with
``record_function``; this module names them itself and imports nothing
of the port.  In a stretch ``[t0, t1]`` (trace microseconds):

- busy: each kernel, copy and set goes to the innermost span open when
  the runtime call that issued it started, the call found by its CUPTI
  correlation id; the union of device intervals is split so that each
  instant counts once (where two intervals overlap, the one that started
  first takes the overlap);
- idle: each gap in that union goes to the innermost span open at the
  gap's start: what the host was doing when the card ran dry;
- syncs: each runtime call of ``trace.SYNCS`` goes to the innermost span
  open when it started.

Spans are taken from every thread: backward launches run on autograd's
device thread while the main thread waits inside ``pcs.backward``.  What
lies in no span is ``outside``.  Busy, idle and syncs each sum to the
stretch's totals as ``trace.summarise`` gives them.

Run on a card, it prints each cell's table of the spans a block:

    python3 -m pcs_bench.spans --workload pointnet_s3dis.train_dense \\
        --seeds 2147483659 --out spans.jsonl
"""
from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

from . import harness, trace

FORWARD, ENCODER, SEARCH, BACKWARD = ("pcs.forward", "pcs.encoder",
                                      "pcs.search", "pcs.backward")
SPANS = (FORWARD, ENCODER, SEARCH, BACKWARD)
OUTSIDE = "outside"
BUCKETS = SPANS + (OUTSIDE,)


class Timeline:
    """The innermost and the outermost port span open at each instant, on
    any thread: piecewise constant between the spans' edges."""

    def __init__(self, spans: List[Tuple[float, float, str]]):
        self.edges = sorted({x for s, e, _ in spans for x in (s, e)})
        self.inner: List[str] = []
        self.root: List[str] = []
        for a in self.edges[:-1]:
            open_ = [(s, -e, name) for s, e, name in spans if s <= a < e]
            self.inner.append(max(open_)[2] if open_ else OUTSIDE)
            self.root.append(min(open_)[2] if open_ else OUTSIDE)

    def at(self, t: float) -> Tuple[str, str]:
        """(innermost, outermost) span open at ``t``; ``outside`` for
        both where none is."""
        i = bisect.bisect_right(self.edges, t) - 1
        if 0 <= i < len(self.inner):
            return self.inner[i], self.root[i]
        return OUTSIDE, OUTSIDE


def attribute(events: List[Dict], t0_us: float, t1_us: float) -> Dict:
    """Busy and idle seconds and syncs of the stretch by innermost span
    (``busy_s``, ``idle_s``, ``syncs``), idle seconds by outermost span
    (``idle_root_s``), device kernel seconds by span (``kernel_s``), the
    spans opened (``spans``, by name), and the clock's checks: device
    events, those whose issuing call was found (``matched``), those that
    start before it (``early``; the most by which one does,
    ``early_max_us``), those issued off the stretch's main thread
    (``off_thread``), and ``clock_us``: over the stretch's tenths (by
    the issuing call's time), the largest distance from zero of the
    tenth's least lag from call to device start.  Where the card idles
    in every tenth, as at each sync, the least lag is a launch's own
    latency, some µs; a larger ``clock_us`` is the device clock drifting
    from the host's, and then gaps are put down to spans by a misplaced
    instant."""
    spans, calls, main = [], {}, None
    for ev in events:
        if ev["cat"] == "user_annotation":
            if ev["name"] in SPANS:
                spans.append((ev["ts"], ev["ts"] + ev["dur"], ev["name"]))
            elif main is None and ev["name"] == trace.WINDOW:
                main = ev.get("tid")
        elif ev["cat"] == "cuda_runtime":
            calls[ev["corr"]] = ev
    tl = Timeline(spans)
    out: Dict = {k: dict.fromkeys(BUCKETS, 0.0)
                 for k in ("busy_s", "idle_s", "idle_root_s")}
    out["syncs"] = dict.fromkeys(BUCKETS, 0)
    kernel_s: Dict[str, Dict[str, float]] = {b: defaultdict(float)
                                             for b in BUCKETS}
    n_dev = matched = early = off_thread = 0
    early_us = 0.0
    least: Dict[int, float] = {}
    dev = []
    for ev in events:
        s = float(ev["ts"])
        e = s + float(ev["dur"])
        if e < t0_us or s > t1_us:
            continue
        if ev["cat"] == "cuda_runtime" and ev["name"] in trace.SYNCS:
            out["syncs"][tl.at(s)[0]] += 1
        if ev["cat"] not in trace.DEVICE_CATS:
            continue
        n_dev += 1
        call = calls.get(ev["corr"])
        where = OUTSIDE
        if call is not None:
            matched += 1
            early += s < call["ts"]
            early_us = max(early_us, call["ts"] - s)
            k = min(9, int(10 * (call["ts"] - t0_us)
                           / max(t1_us - t0_us, 1e-9)))
            least[k] = min(least.get(k, s - call["ts"]), s - call["ts"])
            off_thread += main is not None and call.get("tid") != main
            where = tl.at(call["ts"])[0]
        s, e = max(s, t0_us), min(e, t1_us)
        dev.append((s, e, where))
        if ev["cat"] == "kernel":
            kernel_s[where][ev["name"]] += (e - s) * 1e-6
    dev.sort()
    covered = t0_us
    for s, e, where in dev:
        if s > covered:
            inner, root = tl.at(covered)
            out["idle_s"][inner] += (s - covered) * 1e-6
            out["idle_root_s"][root] += (s - covered) * 1e-6
        if e > max(s, covered):
            out["busy_s"][where] += (e - max(s, covered)) * 1e-6
        covered = max(covered, e)
    if t1_us > covered:
        inner, root = tl.at(covered)
        out["idle_s"][inner] += (t1_us - covered) * 1e-6
        out["idle_root_s"][root] += (t1_us - covered) * 1e-6
    out["kernel_s"] = {b: dict(v) for b, v in kernel_s.items()}
    count: Dict[str, int] = dict.fromkeys(SPANS, 0)
    for s, e, name in spans:
        count[name] += e >= t0_us and s <= t1_us
    out["spans"] = count
    out.update(device_events=n_dev, matched=matched, early=early,
               early_max_us=early_us, off_thread=off_thread,
               clock_us=max((abs(v) for v in least.values()), default=0.0))
    return out


# the per-layer numbers a block: name -> (spans it reads, value of an
# attribution in its own unit); ``.train`` and ``.label`` cells read the
# same quantity
METRICS = {
    "search_ms_per_block": ((SEARCH,), lambda a: 1e3 * a["busy_s"][SEARCH]),
    "conv_ms_per_block": ((ENCODER,), lambda a: 1e3 * a["busy_s"][ENCODER]),
    "backward_ms_per_block": ((BACKWARD,),
                              lambda a: 1e3 * a["busy_s"][BACKWARD]),
    "forward_idle_ms_per_block": (
        (FORWARD,), lambda a: 1e3 * a["idle_root_s"][FORWARD]),
    "backward_idle_ms_per_block": (
        (BACKWARD,), lambda a: 1e3 * a["idle_root_s"][BACKWARD]),
    "model_syncs_per_block": (
        (FORWARD,), lambda a: sum(a["syncs"][s] for s in SPANS)),
}


def read(name: str, att: Dict, blocks: int) -> Optional[float]:
    """Metric ``name`` of an attribution over ``blocks`` blocks; None
    where the stretch has no device event or the port opened none of the
    spans it reads (a program without them)."""
    needs, value = METRICS[name]
    if att["device_events"] == 0 or not all(att["spans"][s] for s in needs):
        return None
    return value(att) / blocks


def partition_gaps(att: Dict, summary: Dict) -> Dict[str, float]:
    """How far the attribution's sums lie from ``summarise``'s totals:
    busy and idle relative to them, syncs as a count."""
    busy = sum(att["busy_s"].values())
    idle = sum(att["idle_s"].values())
    want_idle = summary["window_s"] - summary["busy_s"]
    return {"busy": abs(busy - summary["busy_s"]) / max(summary["busy_s"],
                                                        1e-12),
            "idle": abs(idle - want_idle) / max(want_idle, 1e-12),
            "syncs": sum(att["syncs"].values()) - summary["syncs"]}


def measure(cell: harness.Cell, seed: int, device, warm_s: float,
            stretches: int) -> List[Dict]:
    """Set a cell up from ``seed``, run it ``warm_s`` seconds, then take
    ``stretches`` traced stretches; one record each."""
    drv = harness.driver(cell.traffic["entry"])(cell.config, cell.traffic,
                                                seed, device)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < warm_s:
        drv.unit()
    drv.close()
    units = cell.traffic["trace_units"]
    blocks = units * drv.blocks_per_unit
    kind = cell.traffic["rate_metric"].split("_")[0]
    out = []
    for i in range(stretches):
        st = trace.stretch(drv, units)
        summary = trace.summarise(st["events"], st["t0_us"], st["t1_us"])
        att = attribute(st["events"], st["t0_us"], st["t1_us"])
        top = {b: sorted(v.items(), key=lambda kv: -kv[1])[:6]
               for b, v in att.pop("kernel_s").items()}
        out.append({
            "workload": cell.name, "seed": seed, "stretch": i,
            "blocks": blocks, "window_s": summary["window_s"],
            "blocks_per_s": blocks / summary["window_s"],
            "busy_s": summary["busy_s"], "syncs": summary["syncs"],
            "launches": summary["launches"],
            "per_block": {b: {"busy_ms": 1e3 * att["busy_s"][b] / blocks,
                              "idle_ms": 1e3 * att["idle_s"][b] / blocks,
                              "syncs": att["syncs"][b] / blocks}
                          for b in BUCKETS},
            "metrics": {f"{m}.{kind}": read(m, att, blocks)
                        for m in METRICS
                        if kind == "train" or "backward" not in m},
            "partition_gaps": partition_gaps(att, summary),
            "attribution": att, "top_kernels": top})
    drv.free()
    return out


def table(rec: Dict) -> str:
    """A record's spans a block, one line each, and its totals."""
    lines = [f"{rec['workload']} seed {rec['seed']} stretch "
             f"{rec['stretch']}: {rec['blocks_per_s']:.3f} blocks/s, busy "
             f"{rec['busy_s']:.6f} of {rec['window_s']:.6f} s, "
             f"{rec['syncs']} syncs; partition gaps {rec['partition_gaps']}"]
    for b, v in rec["per_block"].items():
        lines.append(f"  {b:13s} busy {v['busy_ms']:10.4f} ms  idle "
                     f"{v['idle_ms']:10.4f} ms  syncs {v['syncs']:7.3f}")
    att = rec["attribution"]
    lines.append(f"  device events {att['device_events']}, matched "
                 f"{att['matched']}, early {att['early']} (at most "
                 f"{att['early_max_us']:.3f} us), clock "
                 f"{att['clock_us']:.3f} us, off the main thread "
                 f"{att['off_thread']}; spans {att['spans']}")
    lines.append(f"  metrics {rec['metrics']}")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", nargs="+", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--warm", type=float, default=5.0,
                   help="seconds of closed loop before the stretches")
    p.add_argument("--stretches", type=int, default=3)
    p.add_argument("--out", default=None, help="JSON lines, one a stretch")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("[pcs_bench.spans] needs a CUDA device", file=sys.stderr)
        return 1
    print(f"[pcs_bench.spans] {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}", flush=True)
    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    recs = []
    for w in args.workload:
        for seed in args.seeds:
            for rec in measure(harness.Cell(bench, w), seed, "cuda:0",
                               args.warm, args.stretches):
                print(table(rec), flush=True)
                recs.append(rec)
            rates = [r["blocks_per_s"] for r in recs
                     if r["workload"] == w and r["seed"] == seed]
            print(f"{w} seed {seed}: median {statistics.median(rates):.4f} "
                  f"blocks/s over {len(rates)} stretches", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            for rec in recs:
                f.write(json.dumps(harness.json_safe(rec)) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
