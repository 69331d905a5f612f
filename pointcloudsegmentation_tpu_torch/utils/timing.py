"""Milliseconds per call on the card (the port's counterpart of
``scripts/microbench.py:repeat_timed``): CUDA events around a run of eager
calls, host dispatch included, or around replays of a CUDA graph that holds
the calls, device time only.  Both raise where there is no CUDA device:
a CPU run gives no device time.  ``card`` names the card they ran on."""
from __future__ import annotations

import subprocess
from typing import Callable

import torch


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (first card).  Every
    time taken on the card is reported beside this line."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0].strip()


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("timing on the card needs a CUDA device")


def cuda_ms(fn: Callable[[], object], iters: int = 20,
            warmup: int = 3) -> float:
    """Mean milliseconds per eager call of ``fn`` on the current stream,
    between two CUDA events after ``warmup`` calls."""
    _require_cuda()
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn: Callable[[], object], calls: int = 20,
             replays: int = 5) -> float:
    """Mean device milliseconds per call of ``fn``: ``calls`` calls captured
    in one CUDA graph, replayed ``replays`` times between CUDA events, so
    the host's dispatch cost is not in the time.  ``fn`` must not
    synchronise with the host."""
    _require_cuda()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)
