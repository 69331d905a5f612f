"""Gather-minimal PointNet conv (mirror of
``pointcloudsegmentation_tpu.models.fast_conv.PointNetConvFast`` on its
windowed-plus-pool path with the search's sxyz).

Every Dense over the growth concat ``[cen ‖ nbr ‖ sxyz ‖ c_1 …]`` is split
into per-source projections; all layers' neighbor projections come from the
same input, so they are fused into one [N, ΣD] projection and gathered once
(through the window-gather kernel on CUDA)."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops import neighbors as nb
from .layers import Dense

_NEG = -1e30


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

    def forward(self, sxyz: torch.Tensor, feats: torch.Tensor,
                nbr) -> torch.Tensor:
        """sxyz [N, K, 3] (already divided by the stage rescale), feats
        [N, F], nbr a WindowedNeighborhood or Neighborhood -> [N, Dout]."""
        fc = lambda name: getattr(self, name)  # noqa: E731
        nbr_proj = torch.cat([fc(f"fc_{i}_nbr")(feats)
                              for i in range(len(self.dims))], dim=-1)
        nbr_all = nb.gather_neighbors(nbr_proj, nbr)          # [N, K, ΣD]
        hiddens = []
        out = None
        for i in range(len(self.dims)):
            acc = fc(f"fc_{i}_cen")(feats)[:, None, :] \
                + nbr_all[..., self.offs[i]:self.offs[i + 1]] \
                + fc(f"fc_{i}_sxyz")(sxyz)
            for j, h in enumerate(hiddens):
                acc = acc + fc(f"fc_{i}_h{j}")(h)
            if i < self.n_hidden:
                hiddens.append(torch.relu(acc))
            else:
                out = acc
        mask = nbr.mask
        best = torch.where(mask[..., None], out,
                           torch.full_like(out, _NEG)).amax(dim=1)
        any_valid = mask.any(dim=1)
        return torch.where(any_valid[:, None], best, torch.zeros_like(best))
