"""Gaussian k-NN probability interpolation onto a full-resolution cloud on
the device: ``interpolate_probs``, the mirror of
``pointcloudsegmentation_tpu.ops.interpolate``, and
``interpolate_probs_exact``, the device arm of
``eval.interpolate.interpolate_to_dense``, which takes the neighbours the
native host library takes.  Weights are ``exp(-d² · ratio)`` normalised per query; the
reference's ratios are ``1/(2·0.075²)`` for S3DIS (6-NN) and
``1/(2·0.125²)`` for Semantic3D (8-NN)."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import search


def interpolate_probs(sxyz: torch.Tensor, smask: torch.Tensor,
                      sprobs: torch.Tensor, qxyz: torch.Tensor,
                      qmask: torch.Tensor, k: int = 6,
                      ratio: float = 1.0 / (2 * 0.075 * 0.075),
                      chunk: int = 1024) -> torch.Tensor:
    """Class probabilities of the sampled points interpolated onto the
    query points (JAX ``ops/interpolate.py:20-44``).

    sxyz [Ns, 3] / smask [Ns]: the support (sampled) points; sprobs [Ns, C].
    qxyz [Nq, 3] / qmask [Nq]: the queries.  The k nearest valid support
    points of each query (``search.knn_in_support``, ``chunk`` queries at a
    time) weigh in by ``exp(-(d² - min d²) · ratio)``: shifting by the
    query's smallest distance changes nothing after the normalisation but
    keeps a far query from underflowing to all-zero weights.  A query with
    no valid neighbour gets zeros.  Returns qprobs [Nq, C] float32."""
    idx, d2, valid = search.knn_in_support(qxyz, qmask, sxyz, smask, k,
                                           chunk=chunk)
    return _weigh(idx, d2, valid, sprobs, ratio)


def knn_exact(query: torch.Tensor, support: torch.Tensor, k: int,
              cell_hint: float = 0.3, chunk: int = 1024, window: int = 32
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest support points of each query as the native host
    library's k-NN (``csrc/pointutil.cpp:pcs_knn``, built with grid cell
    ``cell_hint``) takes them: by the squared distance of the coordinate
    differences in its rounding (``_native_sqnorm``), and among points at
    one distance by its order (``_native_ties``).

    ``search.knn_in_support`` scores ``|q|² + |s|² - 2 q·s``, which rounds
    to a few float32 ulps of the squared coordinates: at a scan's tens of
    metres that is about 1e-4 m², wider than the gaps between a query's
    k-th and (k+1)-th nearest points where overlapping blocks put copies
    of one point, an ulp apart, into the support.  Here, per ``chunk``
    queries, the [chunk, Ns] distances of the differences (within a few
    ulps of the fused form) pick ``window`` candidates (``_candidates``),
    whose fused distances the library's order then ranks.  Returns (idx
    [Nq, k'] int64, d2 [Nq, k'] float32) ascending by (d2, idx),
    k' = min(k, Ns)."""
    k = min(k, support.shape[0])
    visit = _native_cells(support, cell_hint) * support.shape[0] \
        + torch.arange(support.shape[0], device=support.device)
    idx = torch.empty((query.shape[0], k), dtype=torch.long,
                      device=query.device)
    d2 = torch.empty((query.shape[0], k), dtype=torch.float32,
                     device=query.device)
    for beg in range(0, query.shape[0], chunk):
        q = query[beg:beg + chunk]
        dq = (q[:, None, 0] - support[None, :, 0]) ** 2
        dq += (q[:, None, 1] - support[None, :, 1]) ** 2
        dq += (q[:, None, 2] - support[None, :, 2]) ** 2
        ci = _candidates(dq, k, window)
        del dq
        # the candidates in the order the library visits them
        ci = torch.gather(ci, 1, torch.argsort(visit[ci], dim=1))
        fused = _native_sqnorm(support[ci] - q[:, None, :])
        d2[beg:beg + chunk], idx[beg:beg + chunk] = _native_ties(fused, ci,
                                                                 k)
    return idx, d2


def _candidates(dq: torch.Tensor, k: int, window: int) -> torch.Tensor:
    """Columns of the ``window`` smallest of each row of ``dq`` [rows, Ns]
    that hold every point whose fused distance can reach the row's k-th:
    the float32 sums of the plain and the fused form are each within
    7 float32 ulps (relatively) of the exact distance, so a point left out
    is farther than the k-th once the window's last distance exceeds the
    k-th by a relative 2**-16.  Where a row's window is all within that of
    its k-th (more copies of one point than the window holds), the window
    doubles.  Returns [rows, w] int64."""
    w = min(window, dq.shape[1])
    while True:
        dist, ci = torch.topk(dq, w, dim=1, largest=False, sorted=True)
        if w == dq.shape[1] or bool(
                (dist[:, -1] > dist[:, k - 1] * (1 + 2.0 ** -16)).all()):
            return ci
        w = min(2 * w, dq.shape[1])


def _native_cells(support: torch.Tensor, cell_hint: float) -> torch.Tensor:
    """Each support point's cell in the native library's grid
    (``Grid::build``, ``Grid::cell_id``), in its float32 arithmetic: the
    library visits the cells in this index order, and a cell's points in
    index order."""
    cell = torch.tensor(cell_hint, dtype=torch.float32)
    lo, hi = support.amin(0).cpu(), support.amax(0).cpu()

    def dims(cell):
        return [max(1, int((hi[a] - lo[a]) / cell) + 1) for a in range(3)]

    nx, ny, nz = dims(cell)
    n = support.shape[0]
    if nx * ny * nz > 64 * n + 64:       # the library coarsens the grid
        scale = np.cbrt(float(nx * ny * nz) / (64.0 * n + 64.0))
        cell = cell * torch.tensor(scale, dtype=torch.float32)
        nx, ny, nz = dims(cell)
    c = ((support - lo.to(support.device)) / cell.to(support.device)).long()
    c = torch.minimum(c.clamp(min=0), torch.tensor([nx - 1, ny - 1, nz - 1],
                                                   device=support.device))
    return (c[:, 0] * ny + c[:, 1]) * nz + c[:, 2]


def _native_ties(d2: torch.Tensor, idx: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The library's bounded max-heap over candidates in its visiting
    order (``pcs_knn``): a candidate replaces the heap's largest
    (d2, index) pair when its d2 is strictly smaller.  Among points at one
    distance that keeps neither simply the lower indices nor the first
    visited.  Replaying it on [rows, C] candidates that hold every point
    within the k-th distance reproduces the library's choice: points
    farther than that never displace a nearer one.  Returns (d2, idx)
    [rows, k] ascending by (d2, idx)."""
    slots = torch.arange(k, device=d2.device)
    hd = torch.full((d2.shape[0], k), float("inf"), device=d2.device)
    hi = torch.full((d2.shape[0], k), 2 ** 31 - 1, dtype=torch.long,
                    device=d2.device)
    for t in range(d2.shape[1]):
        top = _pair_key(hd, hi).argmax(1, keepdim=True)
        put = (slots == top) & (d2[:, t:t + 1] < torch.gather(hd, 1, top))
        hd = torch.where(put, d2[:, t:t + 1], hd)
        hi = torch.where(put, idx[:, t:t + 1], hi)
    order = _pair_key(hd, hi).argsort(1)
    return torch.gather(hd, 1, order), torch.gather(hi, 1, order)


def _pair_key(d2: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(d2 >= 0, idx) pairs as int64 keys in their lexicographic order."""
    return (d2.contiguous().view(torch.int32).long() << 32) | idx


def interpolate_probs_exact(sxyz: torch.Tensor, sprobs: torch.Tensor,
                            qxyz: torch.Tensor, k: int = 6,
                            ratio: float = 1.0 / (2 * 0.075 * 0.075),
                            cell_hint: float = 0.3,
                            chunk: int = 1024) -> torch.Tensor:
    """``interpolate_probs`` over every point (no masks) on ``knn_exact``:
    the device arm of ``eval.interpolate.interpolate_to_dense``, which
    takes the neighbours the native host library takes.  Returns qprobs
    [Nq, C] float32."""
    idx, d2 = knn_exact(qxyz, sxyz, k, cell_hint=cell_hint, chunk=chunk)
    return _weigh(idx, d2, torch.ones_like(idx, dtype=torch.bool), sprobs,
                  ratio)


def _native_sqnorm(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] float32 -> [...] ``fma(z, z, fma(x, x, y·y))``: the native
    library's ``dx * dx + dy * dy + dz * dz`` as ``g++ -O3 -march=native``
    contracts it on a host with FMA (``csrc/pointutil.cpp``).  Products of
    float32 values are exact in float64, so a float64 multiply-add rounded
    to float32 gives the fused result (up to rare double rounding)."""
    d = v.double()
    acc = (d[..., 1] * d[..., 1]).float().double()
    acc = (d[..., 0] * d[..., 0] + acc).float().double()
    return (d[..., 2] * d[..., 2] + acc).float()


def _weigh(idx: torch.Tensor, d2: torch.Tensor, valid: torch.Tensor,
           sprobs: torch.Tensor, ratio: float) -> torch.Tensor:
    """The Gaussian weights of the valid neighbours, shifted by the
    query's smallest distance and normalised, applied to their
    probabilities."""
    d2 = torch.where(valid, d2, torch.full_like(d2, float("inf")))
    shift = d2.min(dim=-1, keepdim=True).values
    shift = torch.where(torch.isfinite(shift), shift,
                        torch.zeros_like(shift))
    w = torch.where(valid, torch.exp(-(d2 - shift) * ratio),
                    torch.zeros_like(d2))
    w = w / w.sum(dim=-1, keepdim=True).clamp(min=1e-12)
    return torch.einsum("qk,qkc->qc", w, sprobs[idx.long()])
