"""The windowed slab gather in plain PyTorch (the semantics of the port's
window-gather kernel, written out as indexing)."""
from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional

import torch

# the calls of the gather while ``recording`` is open: (n, k, f, element
# bytes, window, tile, whether the features take a gradient)
_calls: Optional[List[tuple]] = None


@contextlib.contextmanager
def recording() -> Iterator[List[tuple]]:
    """Record every call of ``gather_fwd_reference`` made in the body."""
    global _calls
    _calls = calls = []
    try:
        yield calls
    finally:
        _calls = None


def gather_fwd_reference(feats: torch.Tensor, lidx: torch.Tensor,
                         window: int, tile: int) -> torch.Tensor:
    """``out[i, k] = feats_padded[(i // tile) * tile + lidx[i, k]]`` where
    ``feats_padded`` has ``window`` zero rows on each side; an index outside
    ``[0, tile + 2 * window)`` reads zeros.  [N, F], [N, K] -> [N, K, F],
    differentiable in ``feats``."""
    n = feats.shape[0]
    if _calls is not None:
        _calls.append((n, lidx.shape[1], feats.shape[1],
                       feats.element_size(), window, tile,
                       feats.requires_grad))
    s = tile + 2 * window
    fp = torch.nn.functional.pad(feats, (0, 0, window, window))
    tile_start = (torch.arange(n, device=lidx.device) // tile) * tile
    ok = (lidx >= 0) & (lidx < s)
    rows = tile_start[:, None] + lidx.clamp(0, s - 1).long()
    out = fp[rows]
    return torch.where(ok[..., None], out, torch.zeros_like(out))
