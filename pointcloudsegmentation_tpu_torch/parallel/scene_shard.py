"""Scene parallelism: one point cloud sharded over the ranks of a mesh, with
halo exchange for the neighborhoods that cross a cut (mirror of
``pointcloudsegmentation_tpu.parallel.scene_shard``).

- The scene is Morton-sorted once (``ops.morton``), so a contiguous index
  range is a compact region; rank r owns rows ``[r·L, (r+1)·L)``.
- Each rank receives a HALO of ``halo`` rows from each of its ring
  neighbours over the process group (point-to-point sends and receives,
  where JAX uses ``lax.ppermute``): by default the neighbour's rows nearest
  to this shard (``geometric_halo_exchange``), or the neighbour's
  index-adjacent edge (``halo_exchange``).
- Every rank runs the per-block model on [halo | core | halo] in a frame
  centred on its core points and keeps the logits of its core; the cores
  are gathered back into the input order.

``extended_shard`` builds one rank's [halo | core | halo] in a single
process from the whole sorted scene, the same rows the exchange delivers;
``shard_logits`` runs the model on it as that rank would, and
``sequential_scene_apply`` runs the whole scene that way, one shard after
another: the reference the distributed path is held against.

The exchange runs the same code under NCCL and gloo.  Under gloo, whose
CUDA support covers only all_reduce and broadcast, the point-to-point and
gather traffic goes through host copies (``Mesh.wire``).
"""
from __future__ import annotations

import logging
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops import morton
from ..ops.search import sqnorm3
from .mesh import Mesh

log = logging.getLogger(__name__)

_BIG = 3.4e38   # an unreachable probe; its squared distance is inf


def _ring(to_right: Sequence[torch.Tensor], to_left: Sequence[torch.Tensor],
          mesh: Mesh) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Send each of ``to_right`` to the next rank and each of ``to_left``
    to the previous one (the ring wraps); returns (from_left, from_right):
    what the previous rank sent right and what the next rank sent left.
    One batch of point-to-point operations; a ring of one rank hands the
    tensors back, as ``ppermute`` does."""
    if mesh.group is None or mesh.size == 1:
        return list(to_right), list(to_left)
    dev = mesh.wire
    right, left = (mesh.rank + 1) % mesh.size, (mesh.rank - 1) % mesh.size

    def wire(t):
        return (t.to(torch.uint8) if t.dtype == torch.bool else t
                ).to(dev).contiguous()

    sends_r = [wire(t) for t in to_right]
    sends_l = [wire(t) for t in to_left]
    recv_l = [torch.empty_like(t) for t in sends_r]
    recv_r = [torch.empty_like(t) for t in sends_l]
    # tags tell the two directions apart under gloo; NCCL matches the
    # operations between two ranks in the order they are issued, which is
    # the same on both sides (a ring of two sends both ways to one peer)
    ops = ([dist.P2POp(dist.isend, t, right, mesh.group, 2 * i)
            for i, t in enumerate(sends_r)]
           + [dist.P2POp(dist.isend, t, left, mesh.group, 2 * i + 1)
              for i, t in enumerate(sends_l)]
           + [dist.P2POp(dist.irecv, t, left, mesh.group, 2 * i)
              for i, t in enumerate(recv_l)]
           + [dist.P2POp(dist.irecv, t, right, mesh.group, 2 * i + 1)
              for i, t in enumerate(recv_r)])
    for work in dist.batch_isend_irecv(ops):
        work.wait()

    def back(t, like):
        t = t.to(like.device)
        return t.bool() if like.dtype == torch.bool else t

    return ([back(t, s) for t, s in zip(recv_l, to_right)],
            [back(t, s) for t, s in zip(recv_r, to_left)])


def halo_exchange(x: torch.Tensor, halo: int, mesh: Mesh) -> torch.Tensor:
    """[L, ...] shard -> [halo + L + halo, ...]: the right edge of the
    previous rank, the shard, the left edge of the next rank.  The ends of
    the ring receive wrapped rows; ``halo_validity`` masks them."""
    (from_left,), (from_right,) = _ring([x[-halo:]], [x[:halo]], mesh)
    return torch.cat([from_left, x, from_right])


def halo_validity(mask_ext: torch.Tensor, halo: int,
                  mesh: Mesh) -> torch.Tensor:
    """Invalidate the wrapped halo at the ends of the (non-cyclic) scene:
    rank 0 has no real left neighbour, the last rank no right one."""
    pos = torch.arange(mask_ext.shape[0], device=mask_ext.device)
    left_ok = (pos >= halo) | (mesh.rank > 0)
    right_ok = (pos < mask_ext.shape[0] - halo) | (mesh.rank < mesh.size - 1)
    return mask_ext & left_ok & right_ok


def _probes(x: torch.Tensor, m: torch.Tensor,
            num_probes: int) -> torch.Tensor:
    """A strided sample of ``num_probes`` rows of the (Morton-sorted)
    shard; invalid rows become unreachable probes."""
    n = x.shape[0]
    p = min(num_probes, n)
    rows = torch.arange(p, device=x.device) * max(n // p, 1)
    return torch.where(m[rows][:, None], x[rows],
                       torch.full_like(x[rows], _BIG))


def _rank_keys(x: torch.Tensor, m: torch.Tensor, cell_size: float):
    """(positions ranked by probe distance, cell keys or None): the points
    themselves, or with ``cell_size`` > 0 their lattice cells' centres and
    the cells' Morton keys relative to the shard's lowest valid cell."""
    if cell_size <= 0.0:
        return x, None
    cc = torch.floor(x / cell_size)
    low = torch.where(m[:, None], cc, torch.full_like(cc, _BIG)).amin(0)
    key = morton.morton_code(torch.clamp(cc - low[None], 0, 1023)
                             .to(torch.int32))
    return cc * cell_size + 0.5 * cell_size, key


def _select(rank_pos: torch.Tensor, cell_key, m: torch.Tensor,
            nbr_probes: torch.Tensor, halo: int):
    """The ``halo`` rows of a shard nearest to a neighbour's probes
    (distance ``sqrt(min_p |x - probe|²)`` in float32, invalid rows last,
    ties in row order; by (distance, cell key) with cells), and whether
    each is a valid row within reach.  Returns (rows, ok)."""
    d2 = sqnorm3(rank_pos[:, None, :] - nbr_probes[None, :, :])   # [L, p]
    pri = torch.where(m, torch.sqrt(d2.amin(1)),
                      torch.full_like(d2[:, 0], _BIG))
    if cell_key is None:
        sel = torch.argsort(pri, stable=True)[:halo]
    else:
        # lexsort((cell_key, pri)): distance first, then cell key, then row
        by_key = torch.argsort(cell_key, stable=True)
        sel = by_key[torch.argsort(pri[by_key], stable=True)][:halo]
    return sel, pri[sel] < _BIG


def geometric_halo_exchange(x: torch.Tensor, f: torch.Tensor,
                            m: torch.Tensor, halo: int, mesh: Mesh,
                            num_probes: int = 64, cell_size: float = 0.0):
    """[L, ...] shard -> ([halo + L + halo, ...] x, f, mask) where each halo
    holds the neighbour's ``halo`` rows GEOMETRICALLY nearest to this
    shard, not its index-adjacent edge.  Each rank sends a strided sample
    of ``num_probes`` core points to both ring neighbours, ranks its own
    rows by distance to each neighbour's probes, and sends each neighbour
    its top ``halo`` rows.  ``cell_size`` > 0 ranks whole lattice cells
    (cell centre distance, then cell key), so cells arrive intact in
    relevance order (only the budget's last cell may be cut): pass the
    model's coarsest voxel size.  Ring ends receive wrapped packages, which
    the returned mask already invalidates (do NOT apply ``halo_validity``
    again)."""
    probes = _probes(x, m, num_probes)
    (of_left,), (of_right,) = _ring([probes], [probes], mesh)
    rank_pos, cell_key = _rank_keys(x, m, cell_size)
    sel_r, ok_r = _select(rank_pos, cell_key, m, of_right, halo)
    sel_l, ok_l = _select(rank_pos, cell_key, m, of_left, halo)
    (xl, fl, okl), (xr, fr, okr) = _ring(
        [x[sel_r], f[sel_r], ok_r], [x[sel_l], f[sel_l], ok_l], mesh)
    okl = okl & (mesh.rank > 0)
    okr = okr & (mesh.rank < mesh.size - 1)
    return (torch.cat([xl, x, xr]), torch.cat([fl, f, fr]),
            torch.cat([okl, m, okr]))


def exchange_shard(x: torch.Tensor, f: torch.Tensor, m: torch.Tensor,
                   halo: int, mesh: Mesh, halo_mode: str = "geom",
                   halo_cell: float = 0.0):
    """This rank's [halo | core | halo] (x, f, mask) in ``halo_mode``
    ``"geom"`` (``geometric_halo_exchange`` with cells of ``halo_cell``)
    or ``"index"`` (``halo_exchange`` and ``halo_validity``)."""
    if halo_mode == "geom":
        return geometric_halo_exchange(x, f, m, halo, mesh,
                                       cell_size=halo_cell)
    if halo_mode != "index":
        raise ValueError(f"halo_mode must be 'geom' or 'index', got "
                         f"{halo_mode!r}")
    return (halo_exchange(x, halo, mesh), halo_exchange(f, halo, mesh),
            halo_validity(halo_exchange(m, halo, mesh), halo, mesh))


def extended_shard(xs: torch.Tensor, fs: torch.Tensor, ms: torch.Tensor,
                   n_shards: int, shard: int, halo: int,
                   halo_mode: str = "geom", halo_cell: float = 0.0,
                   num_probes: int = 64):
    """Shard ``shard``'s [halo | core | halo] built in one process from the
    whole sorted scene: the rows ``exchange_shard`` delivers to that rank.
    Returns (x, f, mask, rows), ``rows`` the sorted scene's row of every
    entry."""
    n = xs.shape[0]
    L = n // n_shards
    dev = xs.device

    def rows_of(s):
        return torch.arange(s * L, (s + 1) * L, device=dev)

    left, right = (shard - 1) % n_shards, (shard + 1) % n_shards
    if halo_mode == "geom":
        core = rows_of(shard)
        probes = _probes(xs[core], ms[core], num_probes)

        def package(s):
            r = rows_of(s)
            pos, key = _rank_keys(xs[r], ms[r], halo_cell)
            sel, ok = _select(pos, key, ms[r], probes, halo)
            return r[sel], ok

        rl, okl = package(left)
        rr, okr = package(right)
    elif halo_mode == "index":
        rl, rr = rows_of(left)[L - halo:], rows_of(right)[:halo]
        okl, okr = ms[rl], ms[rr]
    else:
        raise ValueError(f"halo_mode must be 'geom' or 'index', got "
                         f"{halo_mode!r}")
    okl = okl & (shard > 0)
    okr = okr & (shard < n_shards - 1)
    rows = torch.cat([rl, rows_of(shard), rr])
    return xs[rows], fs[rows], torch.cat([okl, ms[rows_of(shard)], okr]), rows


def model_receptive_field(arch) -> float:
    """Conservative receptive-field bound of a spec-driven pointnet Arch in
    metres: each conv dilates the field by its search radius.  Use as the
    ``receptive_field`` of the halo check in :func:`scene_apply`."""
    return float(sum(c.radius for st in arch.stages for c in st.convs))


def _neighbor_pairs(xyz_sorted, mask, n_shards: int, receptive_field: float):
    """(xyz f32, mask bool, pi, pj): absolute rows of every valid point
    pair within ``receptive_field`` metres that lies in two different
    shards — the only pairs :func:`required_halo` and
    :func:`geometric_required_halo` read.  One KD-tree per shard and one
    tree-to-tree pass per pair of shards, so the pairs inside a shard (most
    of them at a model's receptive field) are never listed."""
    from scipy.spatial import cKDTree

    xyz = np.asarray(xyz_sorted, np.float32)
    m = np.asarray(mask, bool)
    L = len(xyz) // n_shards
    rows = [s * L + np.nonzero(m[s * L:(s + 1) * L])[0]
            for s in range(n_shards)]
    trees = [cKDTree(xyz[r]) if len(r) else None for r in rows]
    pi, pj = [], []
    for a in range(n_shards):
        for b in range(a + 1, n_shards):
            if trees[a] is None or trees[b] is None:
                continue
            pairs = trees[a].sparse_distance_matrix(
                trees[b], receptive_field, output_type="ndarray")
            pi.append(rows[a][pairs["i"]])
            pj.append(rows[b][pairs["j"]])
    empty = np.zeros(0, np.int64)
    return (xyz, m, np.concatenate(pi) if pi else empty,
            np.concatenate(pj) if pj else empty)


def required_halo(xyz_sorted, mask, n_shards: int, receptive_field: float,
                  percentile: float = 100.0) -> int:
    """Data-driven halo for ``halo_mode="index"`` on a Morton-sorted scene:
    a neighbour within ``receptive_field`` metres in another shard demands
    a halo of its index reach past the cut; returns the ``percentile`` of
    those demands plus one (100 = every cone complete; the Morton curve
    makes the worst case fat-tailed).  Host code (numpy/scipy), run on the
    sorted coordinates (``ops.morton.sort_block`` with the same cell and
    extent)."""
    xyz, m, i, j = _neighbor_pairs(xyz_sorted, mask, n_shards,
                                   receptive_field)
    L = len(xyz) // n_shards
    if len(i) == 0:
        return 1
    lo, hi = np.minimum(i, j), np.maximum(i, j)
    # demand of the hi-side point reaching back past its shard start, and
    # of the lo-side point reaching forward past its shard end
    back = (hi // L) * L - lo
    fwd = hi - ((lo // L) * L + L - 1)
    demands = np.concatenate([back, fwd])
    return int(np.percentile(demands, percentile)) + 1


def geometric_required_halo(xyz_sorted, mask, n_shards: int,
                            receptive_field: float, num_probes: int = 64,
                            cell_size: float = 0.0) -> tuple:
    """Data-driven halo for ``halo_mode="geom"``: ``(need, unreachable)``.
    ``need`` is the smallest halo for which
    :func:`geometric_halo_exchange`'s selection (mirrored here: the same
    probes, distances and tie order) ships every sender row within
    ``receptive_field`` of any receiver row, over every directed pair of
    adjacent shards; ``unreachable`` counts the neighbour pairs that span
    NON-adjacent shards, which no one-hop ring exchange serves.  Pass the
    exchange's ``num_probes`` and ``cell_size``."""
    xyz, m, pi, pj = _neighbor_pairs(xyz_sorted, mask, n_shards,
                                     receptive_field)
    L = len(xyz) // n_shards
    if len(pi) == 0:
        return 1, 0
    i, j = pi // L, pj // L
    unreachable = int((np.abs(i - j) > 1).sum())

    p = min(num_probes, L)
    stride = max(L // p, 1)

    def shard_probes(r):
        rows = r * L + np.arange(p) * stride
        return xyz[rows][m[rows]]

    def rank_of_needed(s, r, needed_idx):
        """The buffer the selection needs to include every ``needed_idx``
        sender row (absolute rows of shard s) for receiver r."""
        rows = np.arange(s * L, (s + 1) * L)
        pr = shard_probes(r)
        if len(pr) == 0 or len(needed_idx) == 0:
            return 1
        pos = xyz[rows]
        if cell_size > 0.0:
            cc = np.floor(pos / cell_size)
            pos = cc * cell_size + 0.5 * cell_size
        dist = np.sqrt(((pos[:, None, :] - pr[None, :, :]) ** 2
                        ).sum(-1)).min(1)
        pri = np.where(m[rows], dist, np.float32(_BIG))
        if cell_size > 0.0:
            cc_i = np.clip(cc - cc[m[rows]].min(0), 0, 1023).astype(np.int64)
            order = np.lexsort((morton.np_morton_code(cc_i), pri))
        else:
            order = np.argsort(pri, kind="stable")
        rank = np.empty(L, np.int64)
        rank[order] = np.arange(L)
        return int(rank[needed_idx - s * L].max()) + 1

    need = 1
    lo_s, hi_s = np.minimum(i, j), np.maximum(i, j)
    for a in np.unique(lo_s[hi_s == lo_s + 1]):
        sel = lo_s == a
        sel &= hi_s == a + 1
        lo = np.unique(np.minimum(pi[sel], pj[sel]))   # senders in shard a
        hi = np.unique(np.maximum(pi[sel], pj[sel]))   # senders in shard a+1
        need = max(need, rank_of_needed(a, a + 1, lo),
                   rank_of_needed(a + 1, a, hi))
    return need, unreachable


def _check_halo(xyz_s, mask_s, n_shards, halo, receptive_field,
                halo_percentile, halo_mode, halo_cell):
    """Raise ``ValueError`` when ``halo`` is below the data-driven
    requirement at ``receptive_field`` (host, once per scene)."""
    xs, ms = xyz_s.cpu().numpy(), mask_s.cpu().numpy()
    if halo_mode == "geom":
        need, unreachable = geometric_required_halo(
            xs, ms, n_shards, receptive_field, cell_size=halo_cell)
        if unreachable:
            log.warning("%d neighbour pairs span NON-adjacent shards and "
                        "cannot be served by the one-hop ring exchange (any "
                        "halo): their receptive cones are cropped",
                        unreachable)
    else:
        need = required_halo(xs, ms, n_shards, receptive_field,
                             percentile=halo_percentile)
    if halo < need:
        raise ValueError(
            f"halo={halo} is below the data-driven requirement {need} "
            f"(halo_mode={halo_mode}, receptive_field={receptive_field} m "
            f"over {n_shards} shards): boundary points would see cropped "
            "neighbourhood cones; raise halo or shard over fewer ranks")


def _frame_center(x: torch.Tensor, m: torch.Tensor,
                  halo_cell: float) -> torch.Tensor:
    """The shard's frame: the mean of its valid CORE points (so the frame
    does not move with the halo), quantised to the ``halo_cell`` lattice so
    the model's voxel walls fall on the cells the sender grouped."""
    center = torch.where(m[:, None], x, torch.zeros_like(x)).sum(0) \
        / m.to(x.dtype).sum().clamp(min=1.0)
    if halo_cell > 0.0:
        center = halo_cell * torch.floor(center / halo_cell)
    return center


def _sorted_scene(xyz, feats, mask, n_shards, halo, sort_cell, scene_extent,
                  receptive_field, halo_percentile, halo_mode, halo_cell):
    n = xyz.shape[0]
    if n % n_shards or not 0 < halo <= n // n_shards:
        raise ValueError(f"{n} points over {n_shards} shards with halo "
                         f"{halo}: need N % shards == 0 and "
                         "0 < halo <= N / shards")
    if halo_mode not in ("geom", "index"):
        raise ValueError(f"halo_mode must be 'geom' or 'index', got "
                         f"{halo_mode!r}")
    xyz_s, mask_s, order, feats_s = morton.sort_block(
        xyz, mask, sort_cell, scene_extent, feats)
    if receptive_field > 0.0:
        _check_halo(xyz_s, mask_s, n_shards, halo, receptive_field,
                    halo_percentile, halo_mode, halo_cell)
    return xyz_s, feats_s, mask_s, morton.inverse_permutation(order)


def scene_apply(apply_fn: Callable, xyz: torch.Tensor, feats: torch.Tensor,
                mask: torch.Tensor, mesh: Mesh, halo: int,
                sort_cell: float = 0.05, scene_extent: float = 1024.0,
                receptive_field: float = 0.0, halo_percentile: float = 99.9,
                halo_mode: str = "geom",
                halo_cell: float = 0.0) -> torch.Tensor:
    """Run a per-block model over ONE scene sharded across the mesh's ranks.

    ``apply_fn(xyz, feats, mask) -> [n, C]`` per-point logits sees
    [halo + L + halo] points in a shard-centred frame.  Every rank passes
    the whole scene (N points, N divisible by the mesh size, halo <= N /
    size; ``scene_extent`` bounds its coordinates for the Morton sort),
    sorts it, keeps its own shard and receives its halos from its ring
    neighbours; returns [N, C] logits in the input order on every rank.

    ``halo_mode``: "geom" (default) ships each neighbour's ``halo``
    geometrically nearest rows (``halo_cell``: the model's coarsest voxel
    makes them whole lattice cells); "index" the index-adjacent edges.
    ``receptive_field`` (metres; :func:`model_receptive_field`) > 0 checks
    the halo against the data-driven requirement first
    (:func:`geometric_required_halo`, or :func:`required_halo` at
    ``halo_percentile``) and raises ``ValueError`` naming it."""
    xyz_s, feats_s, mask_s, inv = _sorted_scene(
        xyz, feats, mask, mesh.size, halo, sort_cell, scene_extent,
        receptive_field, halo_percentile, halo_mode, halo_cell)
    L = xyz.shape[0] // mesh.size
    core = slice(mesh.rank * L, (mesh.rank + 1) * L)
    x, f, m = xyz_s[core], feats_s[core], mask_s[core]
    center = _frame_center(x, m, halo_cell)
    x, f, m = exchange_shard(x, f, m, halo, mesh, halo_mode, halo_cell)
    logits = apply_fn(x - center[None, :], f, m)[halo:halo + L]
    if mesh.group is None:
        return logits[inv]
    wire = logits.to(mesh.wire).contiguous()
    parts = [torch.empty_like(wire) for _ in range(mesh.size)]
    dist.all_gather(parts, wire, group=mesh.group)
    return torch.cat(parts).to(logits.device)[inv]


def shard_logits(apply_fn: Callable, xs: torch.Tensor, fs: torch.Tensor,
                 ms: torch.Tensor, n_shards: int, shard: int, halo: int,
                 halo_mode: str = "geom",
                 halo_cell: float = 0.0) -> torch.Tensor:
    """The core logits of shard ``shard`` of the sorted scene (xs, fs, ms),
    in sorted order: ``apply_fn`` on ``extended_shard`` in the shard's
    frame, what that rank of :func:`scene_apply` computes, in one process
    and with no group."""
    L = xs.shape[0] // n_shards
    core = slice(shard * L, (shard + 1) * L)
    center = _frame_center(xs[core], ms[core], halo_cell)
    x, f, m, _ = extended_shard(xs, fs, ms, n_shards, shard, halo,
                                halo_mode, halo_cell)
    return apply_fn(x - center[None, :], f, m)[halo:halo + L]


def sequential_scene_apply(apply_fn: Callable, xyz: torch.Tensor,
                           feats: torch.Tensor, mask: torch.Tensor,
                           n_shards: int, halo: int, sort_cell: float = 0.05,
                           scene_extent: float = 1024.0,
                           receptive_field: float = 0.0,
                           halo_percentile: float = 99.9,
                           halo_mode: str = "geom",
                           halo_cell: float = 0.0) -> torch.Tensor:
    """:func:`scene_apply` over ``n_shards`` shards in one process, one
    shard after another (:func:`shard_logits`): the reference the sharded
    run is held against."""
    xyz_s, feats_s, mask_s, inv = _sorted_scene(
        xyz, feats, mask, n_shards, halo, sort_cell, scene_extent,
        receptive_field, halo_percentile, halo_mode, halo_cell)
    return torch.cat([shard_logits(apply_fn, xyz_s, feats_s, mask_s,
                                   n_shards, s, halo, halo_mode, halo_cell)
                      for s in range(n_shards)])[inv]
