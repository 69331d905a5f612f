"""Fixed-K multi-band neighbor search: a frozen copy of the port's
``ops/search.py`` with the slab geometry read by plain indexing.

Selection is exact: the score ``|q|^2 + |x|^2 - 2 q.x`` (one matmul), exact
``|x - q|^2`` for band membership (``sqnorm3``), top-k on an int64 key that
packs the score's order-preserving bits above the column index (ties to the
lower index), band compaction by a stable sort on (distance, slot)."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .gather import gather_fwd_reference as gather_fwd
from .neighbors import pool_take
from .types import EdgeOverflow, Neighborhood, WindowedNeighborhood

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


def radius_neighbors(xyz: torch.Tensor, mask: torch.Tensor, radius: float,
                     k: int, min_radius: float = 0.0,
                     chunk: int = 1024) -> Neighborhood:
    """The k nearest valid points within (min_radius, radius] of each
    point (JAX ``ops/search.py:215-269``): per query chunk the [chunk, N]
    selection scores, candidates within the band widened by a slack of
    ``1e-4 * max(radius^2, 1)``, the k smallest (ties to the lower index),
    then the exact ``|x - q|^2`` re-filter of those k.  An annulus
    (``min_radius > 0``) excludes the self pair.  Invalid slots hold the
    point's own index."""
    n = xyz.shape[0]
    dev = xyz.device
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa
    sq_max, sq_min = f32(radius * radius), f32(min_radius * min_radius)
    slack = f32(1e-4) * torch.maximum(sq_max, f32(1.0))
    sq = sqnorm3(xyz)
    row = torch.arange(n, device=dev)
    idx = torch.empty((n, k), dtype=torch.long, device=dev)
    valid = torch.empty((n, k), dtype=torch.bool, device=dev)
    for rows, d2 in _dist_chunks(xyz, sq, min(chunk, n)):
        d2 = d2.clamp(min=0.0)
        cand = (d2 <= sq_max + slack) & (d2 >= sq_min - slack) & mask[None, :]
        if min_radius > 0.0:
            cand &= row[rows, None] != row[None, :]
        top, ti = _topk_smallest(
            torch.where(cand, d2, torch.full_like(d2, _INF)), k)
        exact = sqnorm3(xyz[ti] - xyz[rows, None, :])
        ok = (top < _INF * 0.5) & (exact <= sq_max) & (exact >= sq_min)
        idx[rows], valid[rows] = ti, ok
    valid &= mask[:, None]
    idx = torch.where(valid, idx, row[:, None])
    return Neighborhood(idx=idx.to(torch.int32), mask=valid)


def knn_in_support(query: torch.Tensor, query_mask: torch.Tensor,
                   support: torch.Tensor, support_mask: torch.Tensor,
                   k: int, chunk: int = 1024
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The k nearest valid support points of each query (JAX
    ``ops/search.py:309-345``): per query chunk the [chunk, Ns] scores
    ``|q|^2 + |s|^2 - 2 q.s`` clamped at 0, the k smallest, ties to the
    lower index.  The JAX version splits a support wider than 1024 columns
    into tiles of 512 (``_tiled_top_k``), which selects the same slots in
    the same order as one exact top-k.  Returns (idx [Nq, K] int32, d2
    [Nq, K] float32, valid [Nq, K] bool); an invalid slot (a masked query,
    or fewer than K valid support points) holds index 0 and distance 0."""
    nq = query.shape[0]
    s_sq = sqnorm3(support)
    idx = torch.empty((nq, k), dtype=torch.long, device=query.device)
    d2 = torch.empty((nq, k), dtype=torch.float32, device=query.device)
    for beg in range(0, nq, chunk):
        q = query[beg:beg + chunk]
        dq = (sqnorm3(q)[:, None] + s_sq[None, :]
              - 2.0 * (q @ support.T)).clamp(min=0.0)
        dq = torch.where(support_mask[None, :], dq, torch.full_like(dq, _INF))
        d2[beg:beg + chunk], idx[beg:beg + chunk] = _topk_smallest(dq, k)
    valid = (d2 < _INF * 0.5) & query_mask[:, None]
    return (torch.where(valid, idx, torch.zeros_like(idx)).to(torch.int32),
            torch.where(valid, d2, torch.zeros_like(d2)), valid)


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


def resolve_sel_mode(sel_mode: str) -> str:
    """Reject an unknown windowed selection strategy (JAX ``ops/search.py:
    424-435``): a typo such as ``"salb"`` raises instead of running another
    search.  The JAX version also reads ``PCS_SEL_MODE`` from the
    environment; the port takes the strategy as an argument only."""
    if sel_mode not in ("slab", "global"):
        raise ValueError(f"sel_mode must be 'slab' or 'global', got "
                         f"{sel_mode!r}")
    return sel_mode


def windowed_multi_band_neighbors(xyz: torch.Tensor, mask: torch.Tensor,
                                  bands, tile: int = 256, window: int = 256,
                                  cand_k: int = 64, ov_slots: int = 8,
                                  chunk: int = 2048,
                                  return_sxyz: bool = False,
                                  ov_mode: str = "slots",
                                  edge_ratio: int = 2, ov_window: int = 0,
                                  ov_pool_size: int = 0,
                                  sel_mode: str = "global"):
    """Multi-band search for MORTON-SORTED points, split into windowed slots
    and an overflow tier: per-point overflow slots (``ov_mode="slots"``) or
    one shared edge list (``ov_mode="edges"``).  JAX ``ops/search.py:
    490-766``, with its defaults; the port selects exactly, so it has no
    ``recall_target`` or ``use_approx``.

    Selection (``sel_mode``):

    - ``"global"``: per query chunk the ``cand_k`` nearest valid points by
      selection score over all N columns; the candidates inside the point's
      slab ``[t*tile - window, t*tile + tile + window)`` fill the windowed
      tier (slab-local, their geometry read by the window-gather kernel at
      the clipped slab-local index), and the out-of-slab ones, ranked by
      their selection scores, form an overflow pool of ``2*ov_slots``
      (``min(16, cand_k)`` in edges mode).
    - ``"slab"``: each tile selects its ``cand_k`` nearest candidates from
      its slab ([nt, T, S] scores), and a global pass over the out-of-slab
      columns picks the overflow pool.

    With ``ov_pool_size > 0`` the overflow candidates are deduped per tile
    into a pool of that size and the overflow slots hold pool positions;
    with 0 they hold per-point global indices, their geometry read by plain
    row indexing.  With ``ov_window > 0`` (global selection only; a
    multiple of the tile, at least ``window``) the overflow pool keeps only
    candidates in the wide tier ``[t*tile - ov_window, t*tile + tile +
    ov_window)``, held slab-local there and read by the window-gather
    kernel at ``window=ov_window``; neighbors beyond it drop.  Every band
    then compacts both tiers.  Returns a tuple of WindowedNeighborhood per
    band, or of (WindowedNeighborhood, sxyz [N, K+Ko, 3]) pairs.

    ``ov_mode="edges"`` (JAX ``:695-739``) reads the overflow pool's rows
    without a tile pool (whatever ``ov_pool_size``) and keeps those within
    the level's loosest band limits in one ``EdgeOverflow`` of
    ``edge_ratio * N`` rows (``_edge_list``).  Each band's
    WindowedNeighborhood then has no overflow slots (Ko = 0), and every
    band returns the same edge list: (WindowedNeighborhood, edges), or
    (WindowedNeighborhood, sxyz [N, K, 3], edges) with ``return_sxyz``."""
    n = xyz.shape[0]
    if n % tile or window % tile:
        raise ValueError(f"need N % tile == 0 and window % tile == 0 "
                         f"(N={n}, tile={tile}, window={window})")
    if ov_pool_size < 0:
        raise ValueError(f"ov_pool_size must be >= 0, got {ov_pool_size}")
    if ov_mode not in ("slots", "edges"):
        raise ValueError(f"ov_mode must be slots or edges: {ov_mode}")
    sel_mode = resolve_sel_mode(sel_mode)
    if ov_window and sel_mode == "slab":
        raise ValueError("slab selection has no wide-tier variant")
    if ov_window and (ov_window % tile or ov_window < window):
        raise ValueError(f"ov_window ({ov_window}) must be a multiple of "
                         f"the tile ({tile}) and at least the window "
                         f"({window})")
    edges_mode = ov_mode == "edges"
    dev = xyz.device
    chunk = min(chunk, n)
    sq = sqnorm3(xyz)
    row = torch.arange(n, dtype=torch.int32, device=dev)
    tile_start = (row // tile) * tile
    s = tile + 2 * window
    lo = tile_start - window
    self_local = (row % tile) + window
    ov_pool = min(16, cand_k) if edges_mode else min(2 * ov_slots, cand_k)

    if sel_mode == "slab":
        lci, sel_valid = _slab_select(xyz, sq, mask, tile, window, cand_k)
        in_slab = sel_valid
    else:
        appv, ci = _global_select(xyz, sq, mask, cand_k, chunk)
        sel_valid = appv < _INF * 0.5
        # slab membership and the clipped slab-local index of each candidate
        in_slab = (ci >= lo[:, None]) & (ci < (lo + s)[:, None])
        lci = (ci - lo[:, None]).clamp(0, s - 1).to(torch.int32)

    # exact in-slab geometry through the slab gather (zero rows read past
    # the block's ends, and out-of-slab candidates at their clipped index,
    # are masked by in_slab and sel_valid)
    xyzm = torch.cat([xyz, mask.to(xyz.dtype)[:, None]], dim=-1)
    cand_win = gather_fwd(xyzm, lci, window, tile)             # [N, ck, 4]
    sxyz_win = cand_win[..., :3] - xyz[:, None, :]
    ed2_win = sqnorm3(sxyz_win)
    valid_win = (cand_win[..., 3] > 0.5) & in_slab & sel_valid
    is_self_win = lci == self_local[:, None]

    # the overflow pool: [N, ov_pool] candidates, nearest first
    if sel_mode == "slab":
        oci, opool_mask = _out_of_slab_select(xyz, sq, mask, lo, s, chunk,
                                              ov_pool)
        opool_idx = oci.to(torch.int32)
    else:
        # the out-of-slab candidates, ranked by their selection scores
        ov_valid_sel = ~in_slab & sel_valid
        no_self = torch.zeros_like(in_slab)
        if ov_window:
            lo2 = tile_start - ov_window
            s2 = tile + 2 * ov_window
            ov_valid_sel &= (ci >= lo2[:, None]) & (ci < (lo2 + s2)[:, None])
            src = (ci - lo2[:, None]).clamp(0, s2 - 1)
            self_pad = (row % tile) + ov_window
        else:
            src, self_pad = ci, row
        (opool_idx, opool_mask, _), = _compact_bands(
            appv, ov_valid_sel, no_self, src, None, mask, self_pad,
            ((0.0, 1e15, ov_pool),), [ov_pool])

    pool_gidx = None
    if ov_window:
        # the wide tier's geometry through the slab gather at its width
        ocand = gather_fwd(xyzm, opool_idx, ov_window, tile)   # [N, op, 4]
        ov_src, ov_pad = opool_idx, self_pad
    elif ov_pool_size > 0 and not edges_mode:
        pool_gidx, ppos = _tile_shared_pool(opool_idx, opool_mask, tile,
                                            ov_pool_size)
        pg = xyzm[pool_gidx.reshape(-1).long()].reshape(n // tile,
                                                        ov_pool_size, 4)
        ocand = pool_take(pg, ppos, tile)                      # [N, op, 4]
        opool_mask = opool_mask & (ppos < ov_pool_size)
        ov_src, ov_pad = ppos, torch.full_like(row, ov_pool_size)
    else:
        ocand = xyzm[opool_idx.long()]                         # [N, op, 4]
        ov_src, ov_pad = opool_idx, row
    sxyz_ov = ocand[..., :3] - xyz[:, None, :]
    ed2_ov = sqnorm3(sxyz_ov)
    valid_ov = (ocand[..., 3] > 0.5) & opool_mask

    ks = [k for (_, _, k) in bands]
    wcomp = _compact_bands(ed2_win, valid_win, is_self_win, lci,
                           sxyz_win if return_sxyz else None, mask,
                           self_local, bands, ks)
    if edges_mode:
        # the edge list holds global indices (the wide tier's made global,
        # clipped into the block)
        ogidx = opool_idx if not ov_window else (
            opool_idx + (tile_start - ov_window)[:, None]).clamp(0, n - 1)
        edges = _edge_list(valid_ov, ed2_ov, sxyz_ov, ogidx, bands,
                           edge_ratio * n)
        out = []
        for widx, wm, wsx in wcomp:
            wn = WindowedNeighborhood(
                lidx=widx, wmask=wm, ov_idx=widx.new_zeros((n, 0)),
                ov_mask=wm.new_zeros((n, 0)), window=window, tile=tile)
            out.append((wn, wsx, edges) if return_sxyz else (wn, edges))
        return tuple(out)
    ocomp = _compact_bands(ed2_ov, valid_ov, torch.zeros_like(valid_ov),
                           ov_src, sxyz_ov if return_sxyz else None, mask,
                           ov_pad, bands, [min(ov_slots, k) for k in ks])
    out = []
    for (widx, wm, wsx), (oidx, om, osx) in zip(wcomp, ocomp):
        wn = WindowedNeighborhood(lidx=widx, wmask=wm, ov_idx=oidx,
                                  ov_mask=om, window=window, tile=tile,
                                  ov_window=ov_window, pool_idx=pool_gidx)
        out.append((wn, torch.cat([wsx, osx], dim=1)) if return_sxyz
                   else wn)
    return tuple(out)


def _global_select(xyz: torch.Tensor, sq: torch.Tensor, mask: torch.Tensor,
                   cand_k: int, chunk: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The global selection's candidates: per query chunk the ``cand_k``
    nearest valid points by selection score over all N columns, nearest
    first.  Returns (scores [N, ck], global indices [N, ck] int64); an
    unfilled slot scores ``_INF``."""
    n = xyz.shape[0]
    ci = torch.empty((n, cand_k), dtype=torch.long, device=xyz.device)
    appv = torch.empty((n, cand_k), dtype=xyz.dtype, device=xyz.device)
    for rows, d2 in _dist_chunks(xyz, sq, chunk):
        d2 = torch.where(mask[None, :], d2, torch.full_like(d2, _INF))
        appv[rows], ci[rows] = _topk_smallest(d2, cand_k)
    return appv, ci


def _slab_select(xyz: torch.Tensor, sq: torch.Tensor, mask: torch.Tensor,
                 tile: int, window: int, cand_k: int):
    """The slab selection's windowed candidates: each tile's
    ``min(cand_k, S)`` nearest valid points of its slab by selection score
    ([nt, T, S] scores).  Returns (slab-local indices [N, ck] int32,
    validity [N, ck])."""
    n = xyz.shape[0]
    nt, wt = n // tile, window // tile
    s = tile + 2 * window
    x0 = xyz.reshape(nt, tile, 3)
    sq0 = sq.reshape(nt, tile)
    m0 = mask.reshape(nt, tile)
    tid = torch.arange(nt, device=xyz.device)
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
    return (lci.reshape(n, ck_w).to(torch.int32),
            vw.reshape(n, ck_w) < _INF * 0.5)


def _out_of_slab_select(xyz: torch.Tensor, sq: torch.Tensor,
                        mask: torch.Tensor, lo: torch.Tensor, s: int,
                        chunk: int, ov_pool: int):
    """The slab selection's overflow pool: per query chunk the ``ov_pool``
    nearest valid columns outside the point's slab ``[lo, lo + s)``.
    Returns (global indices [N, ov_pool] int64, validity)."""
    n = xyz.shape[0]
    col = torch.arange(n, device=xyz.device)[None, :]
    oci = torch.empty((n, ov_pool), dtype=torch.long, device=xyz.device)
    ovv = torch.empty((n, ov_pool), dtype=xyz.dtype, device=xyz.device)
    for rows, d2g in _dist_chunks(xyz, sq, chunk):
        qlo = lo[rows, None]
        keep = mask[None, :] & ~((col >= qlo) & (col < qlo + s))
        d2g = torch.where(keep, d2g, torch.full_like(d2g, _INF))
        ovv[rows], oci[rows] = _topk_smallest(d2g, ov_pool)
    return oci, ovv < _INF * 0.5


def _edge_list(valid_ov: torch.Tensor, ed2_ov: torch.Tensor,
               sxyz_ov: torch.Tensor, oci: torch.Tensor, bands,
               e_cap: int) -> EdgeOverflow:
    """The level's shared edge list from the [N, op] out-of-slab
    candidates (nearest first): those within the loosest band limits,
    filled RANK-MAJOR (every point's rank-0 candidate before any rank-1
    one), so that past ``e_cap`` rows the farthest ranks drop across the
    whole level; then stably sorted by center, unfilled rows (center N)
    last, and masked rows given center N - 1 (JAX ``ops/search.py:
    695-737``, which carries the indices as float32 columns of one
    payload: exact below 2^24 rows)."""
    n, op = valid_ov.shape
    dev = valid_ov.device
    max_mx = max(mx for (_, mx, _) in bands)
    min_mn = min(mn for (mn, _, _) in bands)
    keep = valid_ov & (ed2_ov <= max_mx * max_mx) \
        & (ed2_ov >= min_mn * min_mn)
    kf = keep.t().reshape(-1)                                # rank-major
    pos = torch.cumsum(kf.to(torch.int64), 0) - 1
    # rows past the cap go to a pad row at e_cap, sliced off below
    slot = torch.where(kf & (pos < e_cap), pos, torch.full_like(pos, e_cap))
    row = torch.arange(n, device=dev)
    center = torch.full((e_cap + 1,), n, dtype=torch.int64, device=dev)
    nbr = torch.zeros((e_cap + 1,), dtype=torch.int64, device=dev)
    geo = torch.zeros((e_cap + 1, 4), dtype=ed2_ov.dtype, device=dev)
    center[slot] = row[None, :].expand(op, n).reshape(-1)
    nbr[slot] = oci.t().reshape(-1).long()
    geo[slot] = torch.cat([ed2_ov[..., None], sxyz_ov], dim=-1) \
        .transpose(0, 1).reshape(-1, 4)
    # a pad-row write may land last or not; it is dropped either way
    center, nbr, geo = center[:e_cap], nbr[:e_cap], geo[:e_cap]
    order = torch.sort(center, stable=True).indices
    count = kf.sum().clamp(max=e_cap)
    e_mask = torch.arange(e_cap, device=dev) < count
    center = torch.where(e_mask, center[order], torch.full_like(center,
                                                                n - 1))
    geo = geo[order]
    return EdgeOverflow(center=center.to(torch.int32),
                        nbr=nbr[order].to(torch.int32), sxyz=geo[:, 1:],
                        d2=geo[:, 0], mask=e_mask)


def annulus_neighbors(xyz: torch.Tensor, mask: torch.Tensor,
                      min_radius: float, max_radius: float, k: int,
                      chunk: int = 1024) -> Neighborhood:
    """The dilated (annulus) search, ``search_neighborhood_range`` (JAX
    ``ops/search.py:272-277``): ``radius_neighbors`` with ``min_radius``."""
    return radius_neighbors(xyz, mask, max_radius, k, min_radius=min_radius,
                            chunk=chunk)


def band_neighbors_auto(xyz: torch.Tensor, mask: torch.Tensor, bands,
                        cand_k: int = 64, chunk: int = 1024,
                        return_sxyz: bool = False, windowed: bool = True,
                        tile: int = 256, window: int = 256,
                        ov_slots: int = 8, sorted: bool = False,
                        ov_pool_size: int = 0, sel_mode: str = "slab",
                        win_cand_k=None):
    """The JAX ``band_neighbors_auto`` (``ops/search.py:448-487``), with its
    defaults: the windowed search (``tile``, ``window``, ``ov_slots``,
    ``ov_pool_size``, ``sel_mode``) where the caller asserts Morton order
    (``sorted``) and the level is tile-aligned and at least 4 tiles long,
    else the global search.  The windowed search's candidate pool is
    ``effective_win_cand_k(win_cand_k, cand_k, bands, n)``; the global
    search keeps ``min(cand_k, n)``.  ``windowed=False`` takes the global
    search whatever the level (the scene eval's ``--exact-search``).  The
    JAX version reads ``PCS_DISABLE_WINDOWED`` and ``PCS_SEL_MODE`` from
    the environment; the port takes both as arguments only, and selects
    exactly (no ``recall_target``)."""
    sel_mode = resolve_sel_mode(sel_mode)
    n = xyz.shape[0]
    if windowed and sorted and n % tile == 0 and n >= 4 * tile:
        return windowed_multi_band_neighbors(
            xyz, mask, bands, tile=tile, window=window,
            cand_k=effective_win_cand_k(win_cand_k, cand_k, bands, n),
            ov_slots=ov_slots, chunk=min(chunk, n), return_sxyz=return_sxyz,
            ov_pool_size=ov_pool_size, sel_mode=sel_mode)
    return multi_band_neighbors(xyz, mask, bands, cand_k=min(cand_k, n),
                                chunk=min(chunk, n),
                                return_sxyz=return_sxyz)
