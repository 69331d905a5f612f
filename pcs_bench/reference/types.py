"""Neighborhood and pyramid containers: a frozen copy of the port's
``ops/types.py``."""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch


class Neighborhood(NamedTuple):
    """Fixed-degree neighborhood of N points with up to K neighbors each.

    idx:  [N, K] int32 — neighbor point indices; invalid slots point at the
          center itself (safe to gather) and are masked out.
    mask: [N, K] bool  — True where the slot holds a real neighbor.
    """

    idx: torch.Tensor
    mask: torch.Tensor

    @property
    def k(self) -> int:
        """Slots per point (JAX ``ops/types.py:31-33``)."""
        return self.idx.shape[-1]

    def counts(self) -> torch.Tensor:
        """Per-point number of valid neighbors, float32 [N] (JAX
        ``ops/types.py:35-37``)."""
        return self.mask.to(torch.float32).sum(dim=-1)


@dataclass(frozen=True)
class WindowedNeighborhood:
    """Neighborhood of Morton-sorted points split into windowed slots and
    overflow slots (see ``ops.search.windowed_multi_band_neighbors``).

    lidx:     [N, K] int32 — slab-local indices in [0, tile + 2*window): slot
              k of point i names row ``(i//tile)*tile + lidx[i,k] - window``.
    wmask:    [N, K] bool
    ov_idx:   [N, Ko] int32 — out-of-slab neighbors.  With ``pool_idx`` set
              they are positions into the tile-shared pool (invalid slots
              hold P, the null position); with ``ov_window > 0`` they are
              slab-local in the wide tier ``[t*tile - ov_window, t*tile +
              tile + ov_window)`` (invalid slots hold the point's own
              position there); otherwise they are per-point global point
              indices (invalid slots hold the point's own index).  The
              edge-list search
              (``ov_mode="edges"``) gives Ko = 0: its out-of-slab
              neighbors travel in an ``EdgeOverflow``.
    ov_mask:  [N, Ko] bool
    pool_idx: optional [nt, P] int32 — global point indices of each tile's
              pool (invalid entries hold 0 and are never referenced).
    ov_window: the wide tier's half-width (0: no wide tier).
    """

    lidx: torch.Tensor
    wmask: torch.Tensor
    ov_idx: torch.Tensor
    ov_mask: torch.Tensor
    window: int
    tile: int
    ov_window: int = 0
    pool_idx: Optional[torch.Tensor] = None

    @property
    def k(self) -> int:
        """Windowed plus overflow slots per point (JAX
        ``ops/types.py:85-87``)."""
        return self.lidx.shape[-1] + self.ov_idx.shape[-1]

    @property
    def mask(self) -> torch.Tensor:
        return torch.cat([self.wmask, self.ov_mask], dim=-1)

    def counts(self) -> torch.Tensor:
        """Per-point number of valid windowed and overflow slots, float32
        [N] (JAX ``ops/types.py:93-94``)."""
        return self.mask.to(torch.float32).sum(dim=-1)

    @property
    def global_idx(self) -> torch.Tensor:
        """[N, K+Ko] global indices (slab-local, pool and wide-tier slots
        converted, per-point overflow slots as they are; invalid slots hold
        the center's own index)."""
        n = self.lidx.shape[0]
        row = torch.arange(n, dtype=torch.int32, device=self.lidx.device)
        tile_start = (row // self.tile) * self.tile
        self_i = row[:, None]
        gidx = self.lidx + (tile_start - self.window)[:, None]
        gidx = gidx.clamp(0, n - 1)
        gidx = torch.where(self.wmask, gidx, self_i)
        ov = self.ov_idx
        if self.pool_idx is not None and ov.shape[-1] > 0:
            nt, p = self.pool_idx.shape
            ko = ov.shape[-1]
            pos = ov.reshape(nt, -1).clamp(0, p - 1).long()
            ov = torch.gather(self.pool_idx, 1, pos).reshape(n, ko)
            ov = torch.where(self.ov_mask, ov, self_i)
        elif self.ov_window > 0 and ov.shape[-1] > 0:
            ov = (ov + (tile_start - self.ov_window)[:, None]).clamp(0, n - 1)
            ov = torch.where(self.ov_mask, ov, self_i)
        return torch.cat([gidx, ov], dim=-1).to(torch.int32)

    def to_neighborhood(self) -> Neighborhood:
        """Plain global-index view (for oracle tests)."""
        return Neighborhood(idx=self.global_idx, mask=self.mask)


class EdgeOverflow(NamedTuple):
    """One level's out-of-slab neighbors as a shared edge list (JAX
    ``ops/types.py:124-161``): E = edge_ratio * N rows serve every band of
    the level, in place of per-point overflow slots.

    center: [E] int32 — center point index, ascending (masked rows hold
            N - 1, so the whole column stays sorted).
    nbr:    [E] int32 — neighbor point index.
    sxyz:   [E, 3] float32 — xyz[nbr] - xyz[center].
    d2:     [E] float32 — squared edge length.
    mask:   [E] bool — valid rows, a contiguous prefix.
    """

    center: torch.Tensor
    nbr: torch.Tensor
    sxyz: torch.Tensor
    d2: torch.Tensor
    mask: torch.Tensor

    def band_mask(self, min_radius: float,
                  max_radius: float) -> torch.Tensor:
        """The valid rows with min_radius <= length <= max_radius."""
        return self.mask & (self.d2 >= min_radius * min_radius) \
            & (self.d2 <= max_radius * max_radius)


class Level(NamedTuple):
    """One level of the voxel pyramid: padded point set with validity mask."""

    xyz: torch.Tensor   # [V, 3] float32; zeros where invalid
    mask: torch.Tensor  # [V] bool


@dataclass(frozen=True)
class Pyramid:
    """Voxel pooling hierarchy with segment-id maps between levels.

    levels: tuple of ``Level``; levels[0] is the input point set.
    seg:    seg[i] [V_i] int32 maps each point of level i to its voxel in
            level i+1, with V_{i+1} (the overflow slot) for invalid points.
    dxyz:   dxyz[i] [V_i, 3] — xyz minus the containing voxel center, zeros
            where invalid.
    morton_sorted: True iff level 0 is Morton-sorted; levels >= 1 always are.
    """

    levels: Tuple[Level, ...]
    seg: Tuple[torch.Tensor, ...]
    dxyz: Tuple[torch.Tensor, ...]
    morton_sorted: bool = False

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    def level_sorted(self, i: int) -> bool:
        return True if i >= 1 else self.morton_sorted
