"""Static-shape neighborhood and pyramid containers (mirror of
``pointcloudsegmentation_tpu.ops.types``; ``EdgeOverflow`` is not ported)."""
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


@dataclass(frozen=True)
class WindowedNeighborhood:
    """Neighborhood of Morton-sorted points split into windowed slots and
    pooled overflow slots (see ``ops.search.windowed_multi_band_neighbors``).

    lidx:     [N, K] int32 — slab-local indices in [0, tile + 2*window): slot
              k of point i names row ``(i//tile)*tile + lidx[i,k] - window``.
    wmask:    [N, K] bool
    ov_idx:   [N, Ko] int32 — positions into the tile-shared pool
              ``pool_idx`` (invalid slots hold P, the null position).
    ov_mask:  [N, Ko] bool
    pool_idx: [nt, P] int32 — global point indices of each tile's pool
              (invalid entries hold 0 and are never referenced).
    """

    lidx: torch.Tensor
    wmask: torch.Tensor
    ov_idx: torch.Tensor
    ov_mask: torch.Tensor
    window: int
    tile: int
    pool_idx: Optional[torch.Tensor] = None

    @property
    def mask(self) -> torch.Tensor:
        return torch.cat([self.wmask, self.ov_mask], dim=-1)

    @property
    def global_idx(self) -> torch.Tensor:
        """[N, K+Ko] global indices (slab-local and pool slots converted;
        invalid slots hold the center's own index)."""
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
        return torch.cat([gidx, ov], dim=-1).to(torch.int32)

    def to_neighborhood(self) -> Neighborhood:
        """Plain global-index view (for oracle tests)."""
        return Neighborhood(idx=self.global_idx, mask=self.mask)


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
