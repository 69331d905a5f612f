"""Fixed-K multi-band neighbor search (mirror of
``pointcloudsegmentation_tpu.ops.search`` in its production configuration:
windowed slab selection with a tile-shared overflow pool, plus the global
search for levels too small to window).

Selection reproduces the JAX CPU result slot for slot:

- distances use the same formulas: the selection score ``|q|^2 + |x|^2 -
  2 q.x`` (one matmul) and exact ``|x - q|^2`` for band membership, with
  ``|v|^2`` rounded as XLA's fused reduction rounds it (two fused
  multiply-adds, ``sqnorm3``);
- ``lax.top_k`` breaks ties by lower index; ``torch.topk`` promises no
  order, so selection runs ``topk`` on an int64 key that packs the score's
  order-preserving bits above the column index (``_topk_smallest``);
- band compaction orders candidates by (distance, slot) with a stable sort.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..kernels.window_gather import gather_fwd
from .neighbors import pool_take
from .types import Neighborhood, WindowedNeighborhood

_INF = 1e30


def sqnorm3(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] float32 -> [...] squared norm rounded like XLA's fused
    reduction: fma(v2, v2, fma(v1, v1, v0*v0)).  Products of float32 values
    are exact in float64, so a float64 multiply-add rounded to float32 gives
    the fused result (up to rare double rounding)."""
    d = v.double()
    acc = (d[..., 0] * d[..., 0]).float().double()
    acc = (d[..., 1] * d[..., 1] + acc).float().double()
    return (d[..., 2] * d[..., 2] + acc).float()


def _topk_smallest(score: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest float32 scores along the last axis, ascending, ties to
    the lower index — ``lax.top_k`` of the negated scores.  Returns (values,
    int64 indices)."""
    bits = score.contiguous().view(torch.int32).long()
    # order-preserving map of float32 bits onto signed integers
    okey = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    col = torch.arange(score.shape[-1], device=score.device)
    key = (okey << 32) | col
    top = torch.topk(key, k, dim=-1, largest=False, sorted=True).values
    idx = top & 0xFFFFFFFF
    return torch.gather(score, -1, idx), idx


def _compact_bands(ed2: torch.Tensor, valid: torch.Tensor,
                   is_self: torch.Tensor, src_idx: torch.Tensor,
                   sxyz_cand, mask: torch.Tensor, self_pad: torch.Tensor,
                   bands, ks: Sequence[int]) -> List:
    """Per band (mn, mx, _) with k slots: the k nearest candidates with
    mn <= dist <= mx, ordered by (distance, candidate slot).

    ed2 [N, ck] exact squared distances; valid/is_self [N, ck];
    src_idx [N, ck] value to emit per slot; sxyz_cand [N, ck, 3] or None;
    mask [N] query validity; self_pad [N] value for empty slots.
    Returns a list over bands of (idx [N,k], mask [N,k], sxyz or None)."""
    n, ck = ed2.shape
    out = []
    for (mn, mx, _), k in zip(bands, ks):
        in_band = (ed2 <= mx * mx) & (ed2 >= mn * mn) & valid
        if mn > 0.0:
            in_band &= ~is_self
        key = torch.where(in_band, ed2, torch.full_like(ed2, float("inf")))
        order = torch.sort(key, dim=1, stable=True).indices[:, :k]
        count = in_band.sum(dim=1, keepdim=True)
        kk = order.shape[1]
        slot = torch.arange(kk, device=ed2.device)
        m = (slot[None, :] < count) & mask[:, None]
        idx = torch.where(m, torch.gather(src_idx, 1, order),
                          self_pad[:, None].to(src_idx.dtype))
        sxyz = None
        if sxyz_cand is not None:
            sxyz = torch.gather(sxyz_cand, 1,
                                order[..., None].expand(-1, -1, 3))
            sxyz = sxyz * m[..., None].to(sxyz.dtype)
        if kk < k:   # more slots than candidates: pad with empty slots
            pad = k - kk
            idx = torch.cat([idx, self_pad[:, None].to(idx.dtype)
                             .expand(n, pad)], dim=1)
            m = torch.cat([m, m.new_zeros((n, pad))], dim=1)
            if sxyz is not None:
                sxyz = torch.cat([sxyz, sxyz.new_zeros((n, pad, 3))], dim=1)
        out.append((idx.to(torch.int32), m, sxyz))
    return out


def _tile_shared_pool(opool_idx: torch.Tensor, opool_mask: torch.Tensor,
                      tile: int, pool_size: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dedupe each tile's out-of-slab candidate targets into a shared pool.

    opool_idx [N, op] global candidate indices, nearest first;
    opool_mask [N, op].  Returns (pool_gidx [nt, P] int32, zero where
    unused; ppos [N, op] int32 pool position per candidate, P where the
    candidate is invalid or did not fit).  Membership priority: every
    point's rank-0 target before any rank-1 target, then position."""
    n, op = opool_idx.shape
    nt = n // tile
    m = tile * op
    if pool_size > m:
        raise ValueError(f"pool size {pool_size} exceeds the {m} candidates "
                         "of a tile")
    big = 2 ** 30
    dev = opool_idx.device
    cand = opool_idx.reshape(nt, m).long()
    cvalid = opool_mask.reshape(nt, m)
    rank = torch.arange(op, device=dev).repeat(tile)[None, :]
    key = torch.where(cvalid, cand, torch.full_like(cand, big))
    # sort by (key, rank): one int64 key, rank in the low bits
    packed = torch.sort(key * op + rank, dim=1).values
    skey, srank = packed // op, packed % op
    is_first = torch.ones_like(cvalid)
    is_first[:, 1:] = skey[:, 1:] != skey[:, :-1]
    is_first &= skey < big
    pos = torch.arange(m, device=dev)[None, :]
    pri = torch.where(is_first, srank * m + pos, torch.full_like(skey, big))
    spri, order = torch.sort(pri, dim=1, stable=True)
    pool_g = torch.gather(skey, 1, order)[:, :pool_size]
    pool_valid = spri[:, :pool_size] < big
    # candidate -> pool position through a per-tile [N + 1] lookup table
    # (pool entries are unique within a tile; unused ones write column N)
    table = torch.full((nt, n + 1), pool_size, dtype=torch.long, device=dev)
    col = torch.where(pool_valid, pool_g, torch.full_like(pool_g, n))
    table.scatter_(1, col, torch.arange(pool_size, device=dev)
                   .expand(nt, -1).contiguous())
    table[:, n] = pool_size
    ppos = torch.gather(table, 1, torch.where(cvalid, cand,
                                              torch.full_like(cand, n)))
    pool_gidx = torch.where(pool_valid, pool_g, torch.zeros_like(pool_g))
    return pool_gidx.to(torch.int32), ppos.reshape(n, op).to(torch.int32)


def effective_win_cand_k(win_cand_k, cand_k: int, bands, n: int) -> int:
    """Windowed selection pool size: ``win_cand_k`` if set (else
    ``cand_k``), raised to the widest band's slot count, capped at n."""
    ck = cand_k if not win_cand_k else win_cand_k
    ck = max(ck, max(k for (_, _, k) in bands))
    return min(ck, n)


def _dist_chunks(xyz: torch.Tensor, sq: torch.Tensor, chunk: int):
    """Yield (row slice, [rows, N] selection scores |q|^2+|x|^2-2q.x)."""
    n = xyz.shape[0]
    for beg in range(0, n, chunk):
        q = xyz[beg:beg + chunk]
        d2 = sq[beg:beg + chunk, None] + sq[None, :] - 2.0 * (q @ xyz.T)
        yield slice(beg, beg + chunk), d2


def multi_band_neighbors(xyz: torch.Tensor, mask: torch.Tensor, bands,
                         cand_k: int = 64, chunk: int = 1024,
                         return_sxyz: bool = False):
    """Global search: the ``cand_k`` nearest valid points of each point by
    selection score, then per band (min_radius, max_radius, k) the k
    nearest in-band candidates by exact distance.  Returns a tuple of
    Neighborhood per band, or of (Neighborhood, sxyz [N, k, 3]) pairs."""
    n = xyz.shape[0]
    chunk = min(chunk, n)
    sq = sqnorm3(xyz)
    ci = torch.empty((n, cand_k), dtype=torch.long, device=xyz.device)
    for rows, d2 in _dist_chunks(xyz, sq, chunk):
        d2 = torch.where(mask[None, :], d2, torch.full_like(d2, _INF))
        ci[rows] = _topk_smallest(d2, cand_k)[1]
    xyzm = torch.cat([xyz, mask.to(xyz.dtype)[:, None]], dim=-1)
    cand = xyzm[ci]
    sxyz_cand = cand[..., :3] - xyz[:, None, :]
    ed2 = sqnorm3(sxyz_cand)
    row = torch.arange(n, dtype=torch.int32, device=xyz.device)
    comp = _compact_bands(ed2, cand[..., 3] > 0.5, ci == row[:, None].long(),
                          ci.to(torch.int32),
                          sxyz_cand if return_sxyz else None, mask, row,
                          bands, [k for (_, _, k) in bands])
    out = []
    for idx, m, sxyz in comp:
        nb = Neighborhood(idx=idx, mask=m)
        out.append((nb, sxyz) if return_sxyz else nb)
    return tuple(out)


def windowed_multi_band_neighbors(xyz: torch.Tensor, mask: torch.Tensor,
                                  bands, tile: int = 256, window: int = 256,
                                  cand_k: int = 64, ov_slots: int = 8,
                                  chunk: int = 2048,
                                  ov_pool_size: int = 256,
                                  return_sxyz: bool = False):
    """Multi-band search for MORTON-SORTED points, split into windowed slots
    and tile-pooled overflow slots (``sel_mode="slab"``, ``ov_mode="slots"``).

    Each tile of ``tile`` points selects its ``cand_k`` nearest candidates
    from its slab ``[t*tile - window, t*tile + tile + window)``; a global
    pass over the out-of-slab columns picks ``2*ov_slots`` overflow
    candidates per point, deduped per tile into a pool of ``ov_pool_size``.
    Every band then compacts both tiers.  Returns a tuple of
    WindowedNeighborhood per band, or of (WindowedNeighborhood, sxyz
    [N, K+Ko, 3]) pairs."""
    n = xyz.shape[0]
    if n % tile or window % tile:
        raise ValueError(f"need N % tile == 0 and window % tile == 0 "
                         f"(N={n}, tile={tile}, window={window})")
    if ov_pool_size <= 0:
        raise ValueError("the windowed search needs a tile-shared overflow "
                         "pool (ov_pool_size > 0)")
    dev = xyz.device
    chunk = min(chunk, n)
    sq = sqnorm3(xyz)
    row = torch.arange(n, dtype=torch.int32, device=dev)
    s = tile + 2 * window
    self_local = (row % tile) + window
    nt, wt = n // tile, window // tile

    # slab selection: [nt, T, S] scores against each tile's slab
    x0 = xyz.reshape(nt, tile, 3)
    sq0 = sq.reshape(nt, tile)
    m0 = mask.reshape(nt, tile)
    tid = torch.arange(nt, device=dev)
    slab, ssq, sm = [], [], []
    for o in range(-wt, wt + 1):
        slab.append(torch.roll(x0, -o, dims=0))
        ssq.append(torch.roll(sq0, -o, dims=0))
        ok = (tid + o >= 0) & (tid + o < nt)
        sm.append(torch.roll(m0, -o, dims=0) & ok[:, None])
    slab = torch.cat(slab, dim=1)
    ssq = torch.cat(ssq, dim=1)
    sm = torch.cat(sm, dim=1)
    d2w = sq0[:, :, None] + ssq[:, None, :] - 2.0 * torch.einsum(
        "ntd,nsd->nts", x0, slab)
    d2w = torch.where(sm[:, None, :], d2w, torch.full_like(d2w, _INF))
    ck_w = min(cand_k, s)
    vw, lci = _topk_smallest(d2w, ck_w)
    lci = lci.reshape(n, ck_w).to(torch.int32)
    sel_valid = vw.reshape(n, ck_w) < _INF * 0.5

    # exact in-slab geometry through the slab gather (zero rows read past
    # the block's ends are unselected candidates, masked by sel_valid)
    xyzm = torch.cat([xyz, mask.to(xyz.dtype)[:, None]], dim=-1)
    cand_win = gather_fwd(xyzm, lci, window, tile)             # [N, ck, 4]
    sxyz_win = cand_win[..., :3] - xyz[:, None, :]
    ed2_win = sqnorm3(sxyz_win)
    valid_win = (cand_win[..., 3] > 0.5) & sel_valid
    is_self_win = lci == self_local[:, None]

    # out-of-slab selection: the ov_pool nearest columns outside the slab
    ov_pool = min(2 * ov_slots, cand_k)
    lo = (row // tile) * tile - window
    col = torch.arange(n, device=dev)[None, :]
    oci = torch.empty((n, ov_pool), dtype=torch.long, device=dev)
    ovv = torch.empty((n, ov_pool), dtype=xyz.dtype, device=dev)
    for rows, d2g in _dist_chunks(xyz, sq, chunk):
        qlo = lo[rows, None]
        keep = mask[None, :] & ~((col >= qlo) & (col < qlo + s))
        d2g = torch.where(keep, d2g, torch.full_like(d2g, _INF))
        ovv[rows], oci[rows] = _topk_smallest(d2g, ov_pool)
    opool_mask = ovv < _INF * 0.5

    pool_gidx, ppos = _tile_shared_pool(oci, opool_mask, tile, ov_pool_size)
    pg = xyzm[pool_gidx.reshape(-1).long()].reshape(nt, ov_pool_size, 4)
    ocand = pool_take(pg, ppos, tile)                          # [N, op, 4]
    opool_mask = opool_mask & (ppos < ov_pool_size)
    sxyz_ov = ocand[..., :3] - xyz[:, None, :]
    ed2_ov = sqnorm3(sxyz_ov)
    valid_ov = (ocand[..., 3] > 0.5) & opool_mask

    ks = [k for (_, _, k) in bands]
    wcomp = _compact_bands(ed2_win, valid_win, is_self_win, lci,
                           sxyz_win if return_sxyz else None, mask,
                           self_local, bands, ks)
    ocomp = _compact_bands(ed2_ov, valid_ov, torch.zeros_like(valid_ov),
                           ppos, sxyz_ov if return_sxyz else None, mask,
                           torch.full_like(row, ov_pool_size), bands,
                           [min(ov_slots, k) for k in ks])
    out = []
    for (widx, wm, wsx), (oidx, om, osx) in zip(wcomp, ocomp):
        wn = WindowedNeighborhood(lidx=widx, wmask=wm, ov_idx=oidx,
                                  ov_mask=om, window=window, tile=tile,
                                  pool_idx=pool_gidx)
        out.append((wn, torch.cat([wsx, osx], dim=1)) if return_sxyz
                   else wn)
    return tuple(out)
