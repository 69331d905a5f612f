"""Neighborhood gathers and masked reductions: a frozen copy of the port's
``ops/neighbors.py`` with every windowed gather done by plain indexing
(``gather.gather_fwd_reference``), whose backward is autograd's."""
from __future__ import annotations

import torch

from .gather import gather_fwd_reference
from .types import Neighborhood, WindowedNeighborhood


def windowed_gather(feats: torch.Tensor,
                    wn: WindowedNeighborhood) -> torch.Tensor:
    """Windowed-slot gather [N, F] -> [N, K, F] (overflow slots excluded),
    differentiable in ``feats``."""
    return gather_fwd_reference(feats, wn.lidx, wn.window, wn.tile)


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
    WindowedNeighborhood gives the [N, K + Ko, F] combined view; its
    wide-tier overflow slots (``ov_window > 0``) are the windowed gather at
    ``window=ov_window`` (JAX ``ops/neighbors.py:186-187``), its per-point
    overflow slots a plain row gather (JAX ``:189``)."""
    if isinstance(nbr, WindowedNeighborhood):
        win = windowed_gather(feats, nbr)
        if nbr.ov_idx.shape[-1] == 0:
            return win
        if nbr.pool_idx is not None:
            ov = _pool_gather(feats, nbr)
        elif nbr.ov_window > 0:
            ov = gather_fwd_reference(feats, nbr.ov_idx,
                                      nbr.ov_window, nbr.tile)
        else:
            ov = feats[nbr.ov_idx.long()]
        return torch.cat([win, ov], dim=1)
    return feats[nbr.idx.long()]


def neighbor_diff(vals: torch.Tensor, nbr) -> torch.Tensor:
    """Per-slot ``x_j - x_i`` (JAX ``ops/neighbors.py:228-235``):
    [N, F] -> [N, K, F]; exactly zero on invalid slots, which self-pad."""
    return gather_neighbors(vals, nbr) - vals[:, None, :]


def neighbor_concat(feats: torch.Tensor, nbr) -> torch.Tensor:
    """Per-slot ``[center ‖ neighbor]`` (the reference's
    ``graph_concat_scatter``, tf_ops/graph_conv_layer.py:788-792):
    [N, F] -> [N, K(+Ko), 2F]."""
    neigh = gather_neighbors(feats, nbr)
    return torch.cat([feats[:, None, :].expand_as(neigh), neigh], dim=-1)


def masked_max(edge_feats: torch.Tensor, nbr, edges=None,
               edge_band=None, edge_vals=None) -> torch.Tensor:
    """Max over valid slots, 0 for a point without one (JAX
    ``ops/neighbors.py:249-262``): [N, K, F] -> [N, F].

    With an ``EdgeOverflow`` (``edges``), the per-edge values
    ``edge_vals`` [E, F] of its rows within ``edge_band`` = (min_radius,
    max_radius) join the max (JAX ``models/fast_conv.py:129-142``):
    masked rows carry -1e30, the max per center (a segment max whose
    gradient splits evenly among ties, as JAX's) is clamped to -1e30 in
    the edges' dtype and cast to the slots', and a center with a valid
    row counts as having a neighbor."""
    mask = nbr.mask
    best = torch.where(mask[..., None], edge_feats,
                       torch.full_like(edge_feats, -1e30)).amax(dim=1)
    any_valid = mask.any(dim=1)
    if edges is not None:
        n, f = best.shape
        emask = edges.band_mask(*edge_band)
        center = edges.center.long()
        neg = torch.where(emask[:, None], edge_vals,
                          torch.full_like(edge_vals, -1e30))
        seg = neg.new_full((n, f), float("-inf")).scatter_reduce(
            0, center[:, None].expand(-1, f), neg, "amax",
            include_self=False)
        seg = torch.maximum(seg, torch.full_like(seg, -1e30))
        best = torch.maximum(best, seg.to(best.dtype))
        any_valid = any_valid | (torch.zeros(
            n, dtype=torch.float32, device=best.device).scatter_reduce(
            0, center, emask.to(torch.float32), "amax",
            include_self=False) > 0.5)
    return torch.where(any_valid[:, None], best, torch.zeros_like(best))


def masked_sum(edge_feats: torch.Tensor, nbr) -> torch.Tensor:
    """Sum over valid slots (JAX ``:265-269``): [N, K, F] -> [N, F]."""
    return (edge_feats * nbr.mask[..., None].to(edge_feats.dtype)).sum(dim=1)


def masked_mean(edge_feats: torch.Tensor, nbr) -> torch.Tensor:
    """Mean over valid slots, 0 for a point without one (JAX
    ``:272-276``)."""
    return masked_sum(edge_feats, nbr) / nbr.counts()[:, None].clamp(min=1.0)


def masked_mean_eps(edge_feats: torch.Tensor, nbr,
                    eps: float = 1e-3) -> torch.Tensor:
    """The ECD layers' eps-regularised mean ``(1+eps)/(n+eps) * sum``
    (JAX ``:279-285``)."""
    inv = (1.0 + eps) / (nbr.counts()[:, None] + eps)
    return inv * masked_sum(edge_feats, nbr)


def eliminate_center(nbr: Neighborhood) -> Neighborhood:
    """Drop self-edges by a mask update (JAX ``:288-296``)."""
    n = nbr.idx.shape[0]
    self_idx = torch.arange(n, dtype=nbr.idx.dtype,
                            device=nbr.idx.device)[:, None]
    keep = nbr.mask & (nbr.idx != self_idx)
    return Neighborhood(idx=torch.where(keep, nbr.idx, self_idx), mask=keep)


def concat_non_center(feats: torch.Tensor, nbr: Neighborhood):
    """``[center ‖ neighbor]`` over non-self edges (JAX ``:300-304``):
    returns ([N, K, 2F], the neighborhood without self-edges)."""
    nc = eliminate_center(nbr)
    return neighbor_concat(feats, nc), nc
