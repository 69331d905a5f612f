"""The traced stretch and the profiler's reading of it: launches, host
syncs, device time by kernel, the union of device intervals (busy time),
and the longest idle gaps named by what the host was doing.  Read from
the profiler's events, which carry the CUPTI activity categories, the
correlation ids and the threads (``spans.attribute`` reads those)."""
from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, Iterator, List, Tuple

import torch
from torch.profiler import record_function

# the host span around a traced stretch
WINDOW = "bench.window"

LAUNCHES = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaLaunchCooperativeKernel"}
# runtime calls that make the host wait for the device
SYNCS = {"cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy"}
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation", "cuda_runtime"}


@contextlib.contextmanager
def profiled() -> Iterator[Dict]:
    """Profile the body (host and device); on exit the yielded dict holds
    ``events``, the profiler's events as {"cat", "name", "ts", "dur"
    (microseconds), "corr", "tid"}, read in memory: nothing is written to
    disk.  ``corr`` is the CUPTI correlation id (a kernel, copy or set
    shares it with the runtime call that issued it), ``tid`` the thread
    the event started on."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out: Dict = {}
    with profile(activities=acts) as prof:
        yield out
    out["events"] = [{"cat": category(e), "name": e.name(),
                      "ts": e.start_ns() * 1e-3,
                      "dur": e.duration_ns() * 1e-3,
                      "corr": e.correlation_id(),
                      "tid": e.start_thread_id()}
                     for e in prof.profiler.kineto_results.events()]


def stretch(drv, units: int) -> Dict:
    """One traced stretch of a driver: ``units`` units and the host read,
    inside the host span ``WINDOW``.  Returns its ``events`` and the span's
    start and end, ``t0_us`` and ``t1_us``."""
    with profiled() as prof:
        with record_function(WINDOW):
            for _ in range(units):
                drv.unit()
            drv.close()
    t0, t1 = clock_us(prof["events"], WINDOW)
    return {"events": prof["events"], "t0_us": t0, "t1_us": t1}


def category(e) -> str:
    """The CUPTI category of a profiler event, from where it ran and its
    name: on the device ``kernel``, ``gpu_memcpy``, ``gpu_memset``, or
    ``gpu_user_annotation`` (a ``record_function`` span's device side);
    on the host ``user_annotation``, ``cuda_runtime`` (a runtime or
    driver call) or ``cpu_op``."""
    name = e.name()
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        if e.is_user_annotation():
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        return "gpu_memset" if name.startswith("Memset") else "kernel"
    if e.is_user_annotation():
        return "user_annotation"
    if name.startswith(("cuda", "cu")) and "::" not in name:
        return "cuda_runtime"
    return "cpu_op"


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def summarise(events: List[Dict], t0_us: float, t1_us: float,
              top: int = 10) -> Dict:
    """Counts and times of the events between ``t0_us`` and ``t1_us`` (the
    trace's microsecond clock): ``launches``, ``syncs``, ``kernel_s``
    {kernel name: seconds}, ``busy_s`` (the union of device intervals
    clipped to the window), ``window_s``, and the breakdown's
    ``device_ops`` and ``idle_gaps`` ([name, seconds], longest first)."""
    launches = syncs = 0
    kernel_s: Dict[str, float] = defaultdict(float)
    dev: List[Tuple[float, float]] = []
    host: List[Tuple[float, float, str]] = []
    for ev in events:
        cat, name = ev["cat"], ev["name"]
        s = float(ev["ts"])
        e = s + float(ev["dur"])
        if e < t0_us or s > t1_us:
            continue
        if cat == "cuda_runtime":
            launches += name in LAUNCHES
            syncs += name in SYNCS
        if cat in DEVICE_CATS:
            s, e = max(s, t0_us), min(e, t1_us)
            dev.append((s, e))
            if cat == "kernel":
                kernel_s[name] += (e - s) * 1e-6
        elif cat in HOST_CATS:
            host.append((s, e, name))
    busy = _union(dev)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    gaps = []
    edges = [t0_us] + [x for iv in busy for x in iv] + [t1_us]
    for i in range(0, len(edges), 2):
        s, e = edges[i], edges[i + 1]
        if e > s:
            gaps.append((e - s, s))
    gaps.sort(reverse=True)
    host.sort()
    idle = []
    for length, start in gaps[:top]:
        # the innermost host event running when the device went idle
        inner = None
        for hs, he, name in host:
            if hs > start:
                break
            if he >= start and (inner is None or he - hs < inner[0]):
                inner = (he - hs, name)
        idle.append([inner[1] if inner else "(no host event)",
                     length * 1e-6])
    ops = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:top]
    return {"launches": launches, "syncs": syncs, "kernel_s": dict(kernel_s),
            "busy_s": busy_s, "window_s": (t1_us - t0_us) * 1e-6,
            "device_ops": [[n, s] for n, s in ops], "idle_gaps": idle}


def clock_us(events: List[Dict], marker: str) -> Tuple[float, float]:
    """The start and end (trace microseconds) of the host span ``marker``
    (a ``record_function`` name)."""
    for ev in events:
        if ev["name"] == marker:
            return float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])
    raise KeyError(f"the trace has no span {marker!r}")
