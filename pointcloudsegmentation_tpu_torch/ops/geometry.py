"""Per-point geometric features on the device (mirror of
``pointcloudsegmentation_tpu.ops.geometry``): the trace-normalised local
covariance (``computeCovars``' 9 features), colour normalisation and
normal estimation.  On a WindowedNeighborhood the coordinate gather runs
through the window-gather kernel."""
from __future__ import annotations

import torch

from . import neighbors as nb
from . import search


def _local_covariance(xyz: torch.Tensor, nbr) -> torch.Tensor:
    """[N, 3, 3] covariance of each point's valid neighbors about their
    mean, divided by their count (at least 1)."""
    pts = nb.gather_neighbors(xyz, nbr)                       # [N, K, 3]
    m = nbr.mask[..., None].to(torch.float32)
    cnt = nbr.counts()[:, None, None].clamp(min=1.0)
    mean = (pts * m).sum(dim=1, keepdim=True) / cnt
    d = (pts - mean) * m
    return torch.einsum("nki,nkj->nij", d, d) / cnt


def covariance_feats(xyz: torch.Tensor, nbr) -> torch.Tensor:
    """Flattened 3x3 covariance of each point's neighborhood divided by
    its trace + 1e-6, so that it is translation- and scale-invariant (JAX
    ``ops/geometry.py:20-40``): xyz [N, 3] -> [N, 9] float32, zeros for a
    point with no valid neighbor."""
    cov = _local_covariance(xyz, nbr)
    tr = torch.diagonal(cov, dim1=1, dim2=2).sum(-1)[:, None, None]
    cov = cov / (tr + 1e-6)
    return cov.reshape(cov.shape[0], 9)


def covariance_feats_radius(xyz: torch.Tensor, mask: torch.Tensor,
                            radius: float, k: int = 16,
                            chunk: int = 1024) -> torch.Tensor:
    """``covariance_feats`` over the k nearest valid points within
    ``radius`` (``search.radius_neighbors``; JAX ``:43-49``)."""
    nbr = search.radius_neighbors(xyz, mask, radius, k, chunk=chunk)
    return covariance_feats(xyz, nbr)


def normalize_rgb(rgb: torch.Tensor) -> torch.Tensor:
    """Colour to [-1, 1], ``rgb / 127.5 - 1`` (JAX ``:52-55``)."""
    return rgb / 127.5 - 1.0


def estimate_normals(xyz: torch.Tensor, nbr) -> torch.Tensor:
    """Unit normals: the eigenvector of the local covariance's smallest
    eigenvalue, turned into the +z hemisphere (JAX ``:58-76``): xyz
    [N, 3] -> [N, 3], zeros for a point with no valid neighbor.  An
    eigenvector is defined up to sign, and not at all for a repeated
    smallest eigenvalue, so two implementations agree up to sign where
    that eigenvalue is isolated."""
    _, vecs = torch.linalg.eigh(_local_covariance(xyz, nbr))
    normal = vecs[:, :, 0]
    normal = torch.where(normal[:, 2:3] < 0, -normal, normal)
    has = nbr.mask.any(dim=1)[:, None]
    return torch.where(has, normal, torch.zeros_like(normal))
