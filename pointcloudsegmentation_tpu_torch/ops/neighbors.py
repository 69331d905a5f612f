"""Neighborhood gathers (mirror of ``pointcloudsegmentation_tpu.ops.neighbors``
for the parts the inference path runs).

The windowed slots go through the window-gather kernel
(``kernels/window_gather.py``) on CUDA.  Where the JAX CPU path clips a
slab index into the block, the kernel reads zero padding; the two agree
wherever a result is used, because invalid slots self-pad and every valid
slot names a row inside the block."""
from __future__ import annotations

import torch

from ..kernels.window_gather import gather_fwd
from .types import WindowedNeighborhood


def windowed_gather(feats: torch.Tensor,
                    wn: WindowedNeighborhood) -> torch.Tensor:
    """Windowed-slot gather [N, F] -> [N, K, F] (overflow slots excluded)."""
    return gather_fwd(feats.contiguous(), wn.lidx, wn.window, wn.tile)


def pool_take(pvals: torch.Tensor, ppos: torch.Tensor,
              tile: int) -> torch.Tensor:
    """Read per-point values through a tile-shared pool: [nt, P, F] table +
    [N, K] positions -> [N, K, F]; position P reads a zero row."""
    nt, p, f = pvals.shape
    n = ppos.shape[0]
    flat = torch.cat([pvals, pvals.new_zeros((nt, 1, f))], dim=1)
    flat = flat.reshape(-1, f)
    tbase = (torch.arange(n, device=ppos.device) // tile) * (p + 1)
    return flat[ppos.long() + tbase[:, None]]


def _pool_gather(feats: torch.Tensor,
                 wn: WindowedNeighborhood) -> torch.Tensor:
    """Overflow slots through the tile-shared pool: one [nt*P]-row gather,
    then per-point reads from the pool; invalid slots get the center's own
    features (the self-pad contract)."""
    n, f = feats.shape
    nt, p = wn.pool_idx.shape
    pf = feats[wn.pool_idx.reshape(-1).long()].reshape(nt, p, f)
    ov = pool_take(pf, wn.ov_idx, n // nt)
    return torch.where(wn.ov_mask[..., None], ov, feats[:, None, :])


def gather_neighbors(feats: torch.Tensor, nbr) -> torch.Tensor:
    """Point features [N, F] -> per-slot neighbor features [N, K, F].
    Invalid slots hold the center's own features; callers mask.  A
    WindowedNeighborhood gives the [N, K + Ko, F] combined view."""
    if isinstance(nbr, WindowedNeighborhood):
        win = windowed_gather(feats, nbr)
        if nbr.ov_idx.shape[-1] == 0:
            return win
        return torch.cat([win, _pool_gather(feats, nbr)], dim=1)
    return feats[nbr.idx.long()]
