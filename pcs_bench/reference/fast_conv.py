"""Gather-minimal PointNet conv: a frozen copy of the port's
``models/fast_conv.py``.  Every Dense over the growth concat ``[cen ‖ nbr ‖
sxyz ‖ c_1 …]`` is split into per-source projections; the neighbor
projections of all layers are fused into one [N, ΣD] projection and gathered
once."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from . import neighbors as nb
from .layers import Dense


def split_xyz(xyz: torch.Tensor, dtype: torch.dtype
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 xyz [N, 3] -> (hi, mid), the coordinate columns of the fold's
    stream: hi = xyz in ``dtype``, mid = the remainder in ``dtype`` (hi +
    mid rebuilds xyz to 2^-16 relative in bfloat16)."""
    hi = xyz.to(dtype)
    return hi, (xyz - hi.float()).to(dtype)


class PointNetConvFast(nn.Module):
    def __init__(self, in_dim: int, fc_dims: Sequence[int], out_dim: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dims = list(fc_dims) + [out_dim]
        self.n_hidden = len(fc_dims)
        self.offs = [0]
        for d in self.dims:
            self.offs.append(self.offs[-1] + d)
        for i, d in enumerate(self.dims):
            self.add_module(f"fc_{i}_nbr", Dense(in_dim, d, bias=False,
                                                 dtype=dtype))
            self.add_module(f"fc_{i}_cen", Dense(in_dim, d, dtype=dtype))
            self.add_module(f"fc_{i}_sxyz", Dense(3, d, bias=False,
                                                  dtype=dtype))
            for j in range(i):
                self.add_module(f"fc_{i}_h{j}", Dense(self.dims[j], d,
                                                      bias=False, dtype=dtype))

    def _stack(self, nbr_block: torch.Tensor, cens, sx: torch.Tensor
               ) -> torch.Tensor:
        """The growth layer stack on one block of slots or edges: layer i
        sums its center projection, its slice of the gathered neighbor
        projections, its sxyz projection and those of the earlier layers'
        relu outputs."""
        hiddens = []
        for i in range(len(self.dims)):
            acc = cens[i] + nbr_block[..., self.offs[i]:self.offs[i + 1]] \
                + getattr(self, f"fc_{i}_sxyz")(sx)
            for j, h in enumerate(hiddens):
                acc = acc + getattr(self, f"fc_{i}_h{j}")(h)
            if i == self.n_hidden:
                return acc
            hiddens.append(torch.relu(acc))

    def forward(self, sxyz: Optional[torch.Tensor], feats: torch.Tensor,
                nbr, edges=None, edge_band: Optional[Tuple[float, float]]
                = None, edge_rescale: float = 1.0,
                xyz: Optional[torch.Tensor] = None,
                inv_rescale: float = 1.0) -> torch.Tensor:
        """sxyz [N, K, 3] (already divided by the stage rescale), feats
        [N, F], nbr a WindowedNeighborhood or Neighborhood -> [N, Dout].
        With ``xyz`` [N, 3] float32 the layer forms sxyz itself (the xyz
        fold) and ``sxyz`` is ignored.

        ``edges``, an ``EdgeOverflow`` shared by the level's bands (JAX
        ``models/fast_conv.py:122-142``): its rows within ``edge_band`` =
        (min_radius, max_radius) run the same stack, on the neighbor
        projection's row ``nbr``, the center projection's row ``center``
        and ``edges.sxyz / edge_rescale``, and join the max.  Both row
        reads are indexing, whose backward is PyTorch's sort-based
        accumulation (deterministic on the card)."""
        nd = len(self.dims)
        nbr_proj = torch.cat([getattr(self, f"fc_{i}_nbr")(feats)
                              for i in range(nd)], dim=-1)
        cens = [getattr(self, f"fc_{i}_cen")(feats) for i in range(nd)]
        if xyz is not None:
            sd, cdt = nbr_proj.shape[-1], nbr_proj.dtype
            hi, mid = split_xyz(xyz, cdt)
            g = nb.gather_neighbors(torch.cat([nbr_proj, hi, mid], dim=-1),
                                    nbr)                      # [N, K, ΣD+6]
            nbr_all = g[..., :sd]
            xyz_j = g[..., sd:sd + 3].float() + g[..., sd + 3:].float()
            sxyz = ((xyz_j - xyz[:, None, :]) * inv_rescale).to(cdt).detach()
        else:
            nbr_all = nb.gather_neighbors(nbr_proj, nbr)      # [N, K, ΣD]
        out = self._stack(nbr_all, [c[:, None, :] for c in cens], sxyz)
        e_out = None
        if edges is not None:
            e_cen = torch.cat(cens, dim=-1)[edges.center.long()]
            e_cen = [e_cen[:, self.offs[i]:self.offs[i + 1]]
                     for i in range(nd)]
            e_sx = (edges.sxyz / edge_rescale).to(sxyz.dtype)
            e_out = self._stack(nbr_proj[edges.nbr.long()], e_cen, e_sx)
        return nb.masked_max(out, nbr, edges, edge_band, e_out)
