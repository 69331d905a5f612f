"""Morton codes and the block sort: a frozen copy of the port's
``ops/morton.py``."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# 10 bits per axis -> 30-bit codes in int32 (grid up to 1024^3)
_BITS = 10
_INT32_MAX = 2 ** 31 - 1


def _spread3(x: torch.Tensor) -> torch.Tensor:
    """Insert two zero bits between each of the low 10 bits (int32)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_code(coords: torch.Tensor) -> torch.Tensor:
    """[N, 3] int cell coords (each < 1024) -> [N] int32 Z-order codes."""
    c = coords.to(torch.int32)
    return (_spread3(c[:, 0]) | (_spread3(c[:, 1]) << 1)
            | (_spread3(c[:, 2]) << 2))


def np_morton_code(coords: np.ndarray) -> np.ndarray:
    """Host (numpy) copy of :func:`morton_code` for code that sizes or
    checks device selections on the host
    (``parallel.scene_shard.geometric_required_halo``): [N, 3] int cell
    coords -> [N] int64 codes with the same bits."""
    def spread(x):
        x = x.astype(np.int64) & ((1 << _BITS) - 1)
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    return (spread(coords[:, 0]) | (spread(coords[:, 1]) << 1)
            | (spread(coords[:, 2]) << 2))


def masked_min_corner(xyz: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[3] min corner over the valid rows (3.4e38 on an empty set)."""
    big = torch.full_like(xyz, 3.4e38)
    return torch.where(mask[:, None], xyz, big).amin(dim=0)


def morton_order(xyz: torch.Tensor, mask: torch.Tensor, cell: float,
                 block_size: float) -> torch.Tensor:
    """Permutation sorting valid points by Morton code; padded rows sort to
    the end.  The grid origin is the masked min corner quantized to the
    cell lattice; a cell too fine for the 10-bit grid is coarsened so the
    grid still covers the block.  Returns order [N] int64 with
    x_sorted = x[order]."""
    cell = max(float(cell), float(block_size) / (1 << _BITS))
    grid = min(int(-(-block_size // cell)) + 2, 1 << _BITS)
    lo = masked_min_corner(xyz, mask)
    lo = cell * torch.floor(lo / cell)
    c = torch.floor((xyz - lo[None, :]) / cell).to(torch.int32)
    c = c.clamp(0, grid - 1)
    key = morton_code(c)
    key = torch.where(mask, key, torch.full_like(key, _INT32_MAX))
    return torch.sort(key, stable=True).indices


def inverse_permutation(order: torch.Tensor) -> torch.Tensor:
    """inv such that x_sorted[inv] == x."""
    n = order.shape[0]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, dtype=order.dtype, device=order.device)
    return inv


def sort_block(xyz: torch.Tensor, mask: torch.Tensor, cell: float,
               block_size: float, *arrays) -> Tuple:
    """Morton-sort a padded block: returns (xyz_s, mask_s, order, *arrays_s);
    ``arrays`` are further per-point tensors permuted the same way."""
    order = morton_order(xyz, mask, cell, block_size)
    return (xyz[order], mask[order], order) + tuple(a[order] for a in arrays)
