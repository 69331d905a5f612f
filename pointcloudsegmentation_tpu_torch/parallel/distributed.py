"""Multi-process data parallelism (mirror of
``pointcloudsegmentation_tpu.parallel.distributed``).

The JAX package calls ``jax.distributed.initialize`` on every host, builds
one mesh over every device and assembles each host's blocks into a global
array.  Here ``initialize`` joins this process to a ``torch.distributed``
process group through an explicit rendezvous (``init_method``: a
``file://`` store or a ``tcp://host:port`` address; nothing is read from
the environment), ``global_mesh`` spans every rank, and each rank keeps its
own blocks; ``local_batch_to_global`` all-gathers them back into the global
batch where a caller needs to see it whole.  ``run_ranks`` starts the ranks
of one host as spawned processes and waits for them.

Backends are the caller's choice, never a fallback: NCCL (the default on
CUDA devices) needs one card per rank; gloo (the default on the CPU) also
lets several ranks share one card, where the caller asks for it.
"""
from __future__ import annotations

import datetime
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh, rank_device

DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               backend: Optional[str] = None, device="cuda",
               timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """Join the process group of ``world_size`` ranks as ``rank`` through
    ``init_method``; nothing to do for a single process (no
    ``init_method`` and at most one rank), as JAX's ``initialize``.  The
    backend defaults to NCCL for a CUDA ``device`` (this rank's card,
    ``parallel.mesh.rank_device``, becomes the current device) and gloo
    for the CPU.  ``timeout`` bounds
    the rendezvous and every collective.  Raises if the group cannot be
    formed."""
    if init_method is None and (world_size is None or world_size <= 1):
        return
    if init_method is None or world_size is None or rank is None:
        raise ValueError("initialize needs init_method, world_size and rank "
                         "for a process group")
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}")
    if device.type == "cuda":
        device = rank_device(device, backend, rank)
        if device.index is not None:
            torch.cuda.set_device(device)
    elif backend == "nccl":
        raise ValueError("NCCL needs CUDA devices; use gloo on the CPU")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timeout)


def global_mesh(device="cuda") -> Mesh:
    """The mesh over every rank of the process group (of size 1 when the
    process runs alone)."""
    return make_mesh(None, device)


def local_batch_to_global(batch: Dict, mesh: Mesh) -> Dict[str, np.ndarray]:
    """Every rank's blocks gathered in rank order (one ``all_gather`` per
    field, on ``mesh.wire``; every rank must hold as many blocks):
    the global batch whose ``shard_batch`` slices the ranks hold, as numpy
    arrays on every rank."""
    out = {}
    for key, value in batch.items():
        t = (value if isinstance(value, torch.Tensor)
             else torch.as_tensor(np.asarray(value))).to(mesh.wire)
        is_bool = t.dtype == torch.bool
        if is_bool:
            t = t.to(torch.uint8)
        if mesh.group is None:
            parts = [t]
        else:
            parts = [torch.empty_like(t) for _ in range(mesh.size)]
            dist.all_gather(parts, t.contiguous(), group=mesh.group)
        full = torch.cat(parts).cpu()
        out[key] = (full.bool() if is_bool else full).numpy()
    return out


def run_ranks(fn: Callable, n: int, args: Sequence = (),
              timeout: Optional[float] = None) -> None:
    """Run ``fn(rank, *args)`` in ``n`` spawned processes (start method
    ``spawn``: a CUDA process cannot fork) and wait for all of them.
    Raises if one fails, or with ``timeout`` (seconds) if they have not all
    finished by then; every process still running is stopped first."""
    ctx = torch.multiprocessing.spawn(fn, args=tuple(args), nprocs=n,
                                      join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while not ctx.join(None if deadline is None
                           else max(deadline - time.monotonic(), 0.0)):
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(f"{n} ranks did not finish within "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        for p in ctx.processes:
            p.join(10)
