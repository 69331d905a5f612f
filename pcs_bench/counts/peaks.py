"""Published peaks of the cards the benchmark runs on, by
``torch.cuda.get_device_name``: NVIDIA's H100 SXM data sheet, dense rates
without sparsity, at the 700 W power limit."""
from __future__ import annotations

from typing import Dict

import torch

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12,
                              "hbm_bytes_per_s": 3.35e12},
}


def of(device) -> Dict[str, float]:
    """The peaks of the card ``device``; a card not in the table, or a
    device that is no card, raises."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"{device} has no peaks: shares of a peak are read "
                         f"on a card")
    name = torch.cuda.get_device_name(device)
    if name not in PEAKS:
        raise KeyError(f"no peaks for {name!r}: add its data sheet's rates "
                       f"to pcs_bench/counts/peaks.py")
    return PEAKS[name]
