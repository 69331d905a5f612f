"""Host -> device batch transfer (mirror of
``pointcloudsegmentation_tpu.data.provider.device_prefetch``)."""
from __future__ import annotations

from typing import Dict, Iterable, Iterator

import numpy as np
import torch


def to_device(batch: Dict, device) -> Dict:
    """Every array of ``batch`` (numpy or tensor) as a tensor on ``device``;
    other values pass through.  Host arrays bound for a CUDA device are
    pinned and copied with ``non_blocking``, so the copy overlaps the work
    already queued on the card."""
    device = torch.device(device)
    out = {}
    for key, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(v)
        if isinstance(v, torch.Tensor) and v.device != device:
            if device.type == "cuda" and v.device.type == "cpu":
                v = v.pin_memory().to(device, non_blocking=True)
            else:
                v = v.to(device)
        out[key] = v
    return out


def device_prefetch(batches: Iterable[Dict], device) -> Iterator[Dict]:
    """Yield ``batches`` on ``device`` with the next batch's transfer
    issued before the consumer gets the current one."""
    ahead = None
    for b in batches:
        moved = to_device(b, device)
        if ahead is not None:
            yield ahead
        ahead = moved
    if ahead is not None:
        yield ahead
