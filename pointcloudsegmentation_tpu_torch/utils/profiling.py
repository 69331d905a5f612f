"""Profiling and tracing utilities (the port's counterpart of
``pointcloudsegmentation_tpu.utils.profiling``).

Replaces the reference's TF full-trace Chrome timelines
(model_pooling.py:608-619, tf_ops/test/test_speed.py:55-80): ``trace``
writes a ``torch.profiler`` Chrome trace (``*.pt.trace.json``, which
Perfetto reads), ``time_fn`` is a steady-state timer of a function, and
``by_name`` sums profiler rows by name, for ``profile_train`` and
``trace_step``.

``span`` marks the port's layer boundaries.  Four spans are placed, each
once where its layer is entered: ``pcs.forward`` (one block's forward:
``Trainer._accum`` with the loss terms, ``eval_scene_probs`` with the
softmax), ``pcs.encoder`` (``SegmentationModel``'s encoder call),
``pcs.search`` (one stage's neighbourhood search) and ``pcs.backward``
(one block's backward, whose launches run on autograd's device thread
while the span is open).  They appear in every ``torch.profiler`` trace,
so in ``trace``'s Chrome trace (``trace_step``, ``profile_step``) for
Perfetto, on the host clock of the trace's CUDA runtime calls (the
device events' converted times can drift from it within a trace).
"""
from __future__ import annotations

import contextlib
import os
import socket
import time
from collections import defaultdict
from typing import (Callable, Dict, Iterable, Iterator, List, Optional,
                    Tuple)

import torch

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler.record_function(name)`` span while a profiler
    records, else one shared null context: with no profiler a span costs
    a function call and a flag read, not the record function's own
    microseconds."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def trace(logdir: str, cuda: Optional[bool] = None) -> Iterator:
    """Profile the body and write its Chrome trace into ``logdir``:

        with profiling.trace("/tmp/trace"):
            train_step(...)
        # then open /tmp/trace/<host>_<pid>_<time>.pt.trace.json in Perfetto

    CPU activity always; CUDA activity (kernels and copies, from CUPTI)
    when ``cuda`` is true, by default when a card is present, and then the
    card is synchronised before the trace stops.  Yields the
    ``torch.profiler.profile``."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available() if cuda is None else cuda
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        logdir, f"{socket.gethostname()}_{os.getpid()}_{time.time_ns()}"
        ".pt.trace.json"))


def _block_until_ready(out) -> None:
    """Wait for the card where any tensor of ``out`` (nested in tuples,
    lists and dicts) lives on it."""
    stack = [out]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
                return
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (tuple, list)):
            stack.extend(x)


def time_fn(fn: Callable, *args, warmup: int = 2, iters: int = 10,
            **kwargs) -> Dict[str, float]:
    """Steady-state wall-clock of a function (the op-level test_speed
    analog): ``warmup`` calls, then ``iters`` calls each timed up to the
    moment its output is ready on the card.  Returns ms/call statistics."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    _block_until_ready(out)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _block_until_ready(out)
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return {"ms_median": times[len(times) // 2], "ms_min": times[0],
            "ms_max": times[-1],
            "ms_mean": sum(times) / len(times)}


def by_name(rows: Iterable[Tuple[str, float, float]], steps: int = 1
            ) -> Tuple[float, List[Tuple[str, float, float, float]]]:
    """(name, calls, microseconds) rows summed by name -> (total ms per
    step, [(name, calls per step, ms per step, share of the total)]),
    the most time first."""
    agg = defaultdict(lambda: [0.0, 0.0])
    for name, n, us in rows:
        agg[name][0] += n
        agg[name][1] += us
    total_us = sum(us for _, us in agg.values())
    out = [(k, n / steps, us / 1e3 / steps, us / max(total_us, 1e-9))
           for k, (n, us) in agg.items()]
    out.sort(key=lambda r: -r[2])
    return total_us / 1e3 / steps, out
