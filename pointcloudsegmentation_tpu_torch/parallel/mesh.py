"""Data parallelism over ``torch.distributed`` (mirror of
``pointcloudsegmentation_tpu.parallel.mesh``).

The JAX package replicates the params and shards the batch over a 1-D
``data`` mesh of devices, and XLA emits the gradient all-reduce inside the
compiled step.  Here every rank is one process with its own device: a
``Mesh`` names the process group, this rank, the group's size, its backend
and the rank's device; ``shard_batch`` gives the rank its contiguous slice
of a global batch, ``replicate`` makes every rank start from rank 0's
state, and ``train.loop.Trainer(mesh=...)`` reduces each step with one
``all_reduce``.  A process that runs alone has a mesh of size 1 with no
group.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..config import require_device


@dataclass(frozen=True)
class Mesh:
    """The ranks a process belongs to: ``group`` (None for a process that
    runs alone), this process's ``rank`` among ``size``, the group's
    ``backend`` (``"nccl"`` or ``"gloo"``; None without a group) and the
    rank's ``device``."""

    group: Optional[object]
    rank: int
    size: int
    backend: Optional[str]
    device: torch.device

    @property
    def wire(self) -> torch.device:
        """Where tensors travel for point-to-point and gather collectives:
        the host under gloo, whose CUDA support covers only all_reduce,
        broadcast and barrier; the rank's card under NCCL."""
        return torch.device("cpu") if self.backend == "gloo" else self.device


def rank_device(device, backend: Optional[str], rank: int) -> torch.device:
    """The device of ``rank``: under NCCL a bare ``"cuda"`` becomes the
    rank's own card (``cuda:rank`` modulo the cards this host shows); any
    other device is used as given (several gloo ranks may share a card)."""
    device = require_device(device)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"NCCL needs CUDA devices, got {device}")
        if device.index is None:
            device = torch.device("cuda", rank % torch.cuda.device_count())
    return device


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """The mesh of the process group this process belongs to (initialised
    by ``parallel.distributed.initialize``), or of size 1 when the process
    runs alone.  ``n_devices``, if given, must be that size: a process
    cannot join ranks it did not start."""
    if dist.is_available() and dist.is_initialized():
        group, size = dist.group.WORLD, dist.get_world_size()
        rank, backend = dist.get_rank(), dist.get_backend()
    else:
        group, size, rank, backend = None, 1, 0, None
    if n_devices is not None and n_devices != size:
        raise ValueError(f"asked for a mesh of {n_devices} ranks; this "
                         f"process belongs to {size} (start the ranks with "
                         "parallel.distributed.initialize)")
    return Mesh(group, rank, size, backend,
                rank_device(device, backend, rank))


def shard_batch(batch: Dict, mesh: Mesh) -> Dict:
    """This rank's contiguous slice ``[r·B/d, (r+1)·B/d)`` of every field
    of a global batch of B blocks (numpy arrays or tensors; the extra
    fields ``dense_*`` and ``ctx_*`` too).  B must be a multiple of the
    mesh size d: the CLI rounds its batch size, and the test ``Provider``
    pads with masked blocks."""
    sizes = {k: v.shape[0] for k, v in batch.items()}
    b = next(iter(sizes.values()))
    if any(s != b for s in sizes.values()):
        raise ValueError(f"batch fields disagree on the block count: "
                         f"{sizes}")
    if b % mesh.size:
        raise ValueError(f"a batch of {b} blocks does not split over "
                         f"{mesh.size} ranks")
    per = b // mesh.size
    lo = mesh.rank * per
    return {k: v[lo:lo + per] for k, v in batch.items()}


def replicate(state, mesh: Mesh):
    """Rank 0's ``TrainState`` on every rank (one broadcast of params,
    moments, count and step packed in float64, which holds each of them
    exactly), on the rank's device."""
    if mesh.group is None:
        return state
    n = state.params.numel()
    packed = torch.cat([state.params.double(), state.mu.double(),
                        state.nu.double(),
                        state.count.reshape(1).double(),
                        torch.tensor([float(state.step)], dtype=torch.float64,
                                     device=state.params.device)]
                       ).to(mesh.device)
    dist.broadcast(packed, src=0, group=mesh.group)
    f32 = packed.float()
    return replace(state, step=int(packed[-1].item()),
                   params=f32[:n].clone(), mu=f32[n:2 * n].clone(),
                   nu=f32[2 * n:3 * n].clone(),
                   count=packed[3 * n].to(torch.int32))
