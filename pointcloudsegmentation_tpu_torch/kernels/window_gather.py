"""Windowed slab gather and its backward: the Hopper ports of the TPU
kernels ``pointcloudsegmentation_tpu/ops/pallas/window_gather.py:gather_fwd``
(K2) and ``:dslab_bwd`` (K3).

    out[i, k, :]   = feats_padded[(i // T) * T + lidx[i, k]]            (K2)
    dslab[t, s, :] = sum_{i in tile t, k : lidx[i, k] == s} g[i, k, :]  (K3)

where ``feats_padded`` is ``feats`` with W zero rows on each side, T the
tile and W the window; ``lidx`` is slab-local in ``[0, S)``, S = T + 2W (an
index outside that range reads zeros and receives no gradient, as the TPU
kernels' one-hot rows do).  ``WindowGather`` is the differentiable gather:
K2 forward, K3 then the overlap-add of the slabs into point rows backward.

On CUDA tensors ``gather_fwd`` and ``dslab_bwd`` launch the kernels in
``csrc/window_gather.cu`` and ``csrc/window_dslab.cu`` (built with nvcc for
sm_90a at first use into ``_build/`` by ``kernels/_build.py`` and bound
through ctypes) and raise if the build or a launch fails; on CPU tensors
they run their plain versions.
K2 is a byte copy and matches its plain version exactly for every dtype.
K3 is two launches: ``dslab_map`` builds each tile's stable inverse map
(slab row -> the slots that read it, ascending), then a sum kernel adds
each row's slots of float32 or bfloat16 g in float32 in that order,
without float atomics, so it is bitwise repeatable and equal to its plain
version, and rounds once to g's dtype.  Both kernels are bounded by
memory; the design notes are at the top of each CUDA source.  The raw
entry points refuse tensors that require grad: a differentiable gather
goes through ``WindowGather``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
from torch.autograd.function import once_differentiable

from . import _build

_I, _P = ctypes.c_int, ctypes.c_void_p
_ENTRIES = {
    "window_gather": {
        # feats, lidx, out, n, k, row_bytes, tile, window, stream
        "pcs_window_gather": [_P, _P, _P, _I, _I, _I, _I, _I, _P]},
    "window_dslab": {
        # lidx, start, order, n, k, tile, window, stream
        "pcs_window_dslab_map": [_P, _P, _P, _I, _I, _I, _I, _P],
        # g, start, order, dslab, n, k, f, tile, window, dtype, stream
        "pcs_window_dslab_sum": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                 _P]},
}
_DTYPE_CODES: Dict[torch.dtype, int] = {torch.float32: 0, torch.bfloat16: 1}


def _load(name: str) -> ctypes.CDLL:
    return _build.load(name, _ENTRIES[name])


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def gather_fwd_reference(feats: torch.Tensor, lidx: torch.Tensor,
                         window: int, tile: int) -> torch.Tensor:
    """Plain PyTorch version of K2: zero-pad, then index.  [N, F], [N, K]
    -> [N, K, F]."""
    n = feats.shape[0]
    s = tile + 2 * window
    fp = torch.nn.functional.pad(feats, (0, 0, window, window))
    tile_start = (torch.arange(n, device=lidx.device) // tile) * tile
    ok = (lidx >= 0) & (lidx < s)
    rows = tile_start[:, None] + lidx.clamp(0, s - 1).long()
    out = fp[rows]
    return torch.where(ok[..., None], out, torch.zeros_like(out))


def dslab_bwd_reference(g: torch.Tensor, lidx: torch.Tensor, window: int,
                        tile: int) -> torch.Tensor:
    """Plain PyTorch version of K3: a stable sort of the slots by (tile,
    slab row), then ``segment_reduce`` in float32 (each row's slots summed
    in ascending slot order), cast to g's dtype.  [N, K, F], [N, K] ->
    [N/T, S, F]."""
    n, k, f = g.shape
    s = tile + 2 * window
    nt = n // tile
    lid = lidx.reshape(-1).long()
    slot_tile = torch.arange(n * k, device=g.device) // (tile * k)
    ok = (lid >= 0) & (lid < s)
    seg = torch.where(ok, slot_tile * s + lid, torch.full_like(lid, nt * s))
    order = torch.sort(seg, stable=True).indices
    # a scatter-add count, not bincount: it needs no host synchronisation,
    # so the plain version can be timed inside a CUDA graph
    lengths = torch.zeros(nt * s + 1, dtype=torch.long, device=g.device)
    lengths.scatter_add_(0, seg, torch.ones_like(seg))
    rows = g.reshape(n * k, f).float()[order]
    out = torch.segment_reduce(rows, "sum", lengths=lengths, axis=0,
                               unsafe=True)
    return out[:nt * s].reshape(nt, s, f).to(g.dtype)


def dslab_map_reference(lidx: torch.Tensor, window: int,
                        tile: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3's inverse map: per tile, a stable sort
    of the tile-local slot ids by slab row, indices outside [0, S) last.
    [N, K] -> (start [N/T, S+1], order [N/T, T*K]), both int32:
    ``order[t, start[t, r]:start[t, r+1]]`` are the slots of tile t that
    read slab row r, ascending, and ``order[t, start[t, S]:]`` those whose
    index lies outside the slab."""
    n, k = lidx.shape
    s = tile + 2 * window
    lid = lidx.reshape(n // tile, tile * k).long()
    row = torch.where((lid >= 0) & (lid < s), lid, torch.full_like(lid, s))
    order = torch.sort(row, dim=1, stable=True).indices
    counts = torch.zeros((n // tile, s + 1), dtype=torch.long,
                         device=lidx.device)
    counts.scatter_add_(1, row, torch.ones_like(row))
    start = torch.cumsum(counts, dim=1) - counts
    return start.to(torch.int32), order.to(torch.int32)


def _check(x: torch.Tensor, lidx: torch.Tensor, window: int, tile: int,
           what: str) -> None:
    n = x.shape[0]
    if lidx.dim() != 2 or lidx.shape[0] != n:
        raise ValueError(f"lidx must be [{n}, K], got {tuple(lidx.shape)}")
    if tile <= 0 or window < 0 or n % tile or window % tile:
        raise ValueError(f"need N % tile == 0 and window % tile == 0 "
                         f"(N={n}, tile={tile}, window={window})")
    if lidx.dtype != torch.int32:
        raise TypeError(f"lidx must be int32, got {lidx.dtype}")
    if x.device != lidx.device:
        raise ValueError(f"{what} on {x.device}, lidx on {lidx.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _refuse_grad(x: torch.Tensor, name: str) -> None:
    if x.requires_grad:
        raise RuntimeError(f"{name} does not record a backward: use "
                           "WindowGather.apply (ops.neighbors."
                           "windowed_gather) for a differentiable gather")


def _gather(feats: torch.Tensor, lidx: torch.Tensor, window: int,
            tile: int) -> torch.Tensor:
    if feats.dim() != 2:
        raise ValueError(f"feats must be [N, F], got {tuple(feats.shape)}")
    _check(feats, lidx, window, tile, "feats")
    if feats.device.type == "cpu":
        return gather_fwd_reference(feats, lidx, window, tile)
    if not (feats.is_contiguous() and lidx.is_contiguous()):
        raise ValueError("gather_fwd needs contiguous feats and lidx")
    n, f = feats.shape
    k = lidx.shape[1]
    out = torch.empty((n, k, f), dtype=feats.dtype, device=feats.device)
    if out.numel() == 0:
        return out
    lib = _load("window_gather")
    with torch.cuda.device(feats.device):
        err = lib.pcs_window_gather(
            feats.data_ptr(), lidx.data_ptr(), out.data_ptr(), n, k,
            f * feats.element_size(), tile, window, _stream(feats))
    if err != 0:
        raise RuntimeError(f"window-gather kernel launch failed: CUDA error "
                           f"{err}")
    gather_fwd.launches += 1
    return out


def _dslab(g: torch.Tensor, lidx: torch.Tensor, window: int,
           tile: int) -> torch.Tensor:
    if g.dim() != 3 or lidx.shape[-1:] != g.shape[1:2]:
        raise ValueError(f"g must be [N, K, F] with lidx [N, K], got "
                         f"{tuple(g.shape)} and {tuple(lidx.shape)}")
    _check(g, lidx, window, tile, "g")
    if g.device.type == "cpu":
        return dslab_bwd_reference(g, lidx, window, tile)
    if g.dtype not in _DTYPE_CODES:
        raise TypeError(f"dslab_bwd takes {sorted(map(str, _DTYPE_CODES))}, "
                        f"got {g.dtype}")
    if not (g.is_contiguous() and lidx.is_contiguous()):
        raise ValueError("dslab_bwd needs contiguous g and lidx")
    n, k, f = g.shape
    s = tile + 2 * window
    out = torch.empty((n // tile, s, f), dtype=g.dtype, device=g.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    start, order = _map(lidx, window, tile)
    with torch.cuda.device(g.device):
        err = _load("window_dslab").pcs_window_dslab_sum(
            g.data_ptr(), start.data_ptr(), order.data_ptr(), out.data_ptr(),
            n, k, f, tile, window, _DTYPE_CODES[g.dtype], _stream(g))
    if err != 0:
        raise RuntimeError(f"window-dslab sum kernel launch failed: CUDA "
                           f"error {err}")
    dslab_bwd.launches += 1
    return out


def _map(lidx: torch.Tensor, window: int,
         tile: int) -> Tuple[torch.Tensor, torch.Tensor]:
    if not lidx.is_contiguous():
        raise ValueError("dslab_map needs a contiguous lidx")
    n, k = lidx.shape
    s = tile + 2 * window
    start = torch.empty((n // tile, s + 1), dtype=torch.int32,
                        device=lidx.device)
    order = torch.empty((n // tile, tile * k), dtype=torch.int32,
                        device=lidx.device)
    if n == 0 or k == 0:
        return start.zero_(), order
    with torch.cuda.device(lidx.device):
        err = _load("window_dslab").pcs_window_dslab_map(
            lidx.data_ptr(), start.data_ptr(), order.data_ptr(), n, k, tile,
            window, _stream(lidx))
    if err != 0:
        raise RuntimeError(f"window-dslab map kernel launch failed: CUDA "
                           f"error {err}")
    dslab_map.launches += 1
    return start, order


def gather_fwd(feats: torch.Tensor, lidx: torch.Tensor, window: int,
               tile: int) -> torch.Tensor:
    """K2: [N, F] features, [N, K] int32 slab-local indices -> [N, K, F].

    CUDA tensors run the hand-written kernel; CPU tensors the plain version.
    ``gather_fwd.launches`` counts kernel launches (those made inside
    ``WindowGather`` included)."""
    _refuse_grad(feats, "gather_fwd")
    return _gather(feats, lidx, window, tile)


def dslab_bwd(g: torch.Tensor, lidx: torch.Tensor, window: int,
              tile: int) -> torch.Tensor:
    """K3: [N, K, F] slot gradients, [N, K] int32 slab-local indices ->
    [N/T, S, F] slab gradients (the caller overlap-adds them).

    CUDA tensors run the map kernel (``dslab_map``) then the sum kernel;
    CPU tensors the plain version.  ``dslab_bwd.launches`` counts calls
    that launched both (those made inside ``WindowGather`` included)."""
    _refuse_grad(g, "dslab_bwd")
    return _dslab(g, lidx, window, tile)


def dslab_map(lidx: torch.Tensor, window: int,
              tile: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's inverse map: [N, K] int32 slab-local indices -> (start
    [N/T, S+1], order [N/T, T*K]) int32, as ``dslab_map_reference``
    defines them.

    CUDA tensors run the map kernel; CPU tensors the plain version.
    ``dslab_map.launches`` counts its launches (those made inside
    ``dslab_bwd`` included)."""
    _check(lidx, lidx, window, tile, "lidx")
    if lidx.device.type == "cpu":
        return dslab_map_reference(lidx, window, tile)
    return _map(lidx, window, tile)


gather_fwd.launches = 0
dslab_bwd.launches = 0
dslab_map.launches = 0


def overlap_add(dslab: torch.Tensor, n: int, window: int,
                tile: int) -> torch.Tensor:
    """Slab gradients [N/T, S, F] -> point gradients [N, F]: slab chunk j
    (rows [jT, (j+1)T)) of every tile lands on padded rows shifted by jT,
    so the adjoint is S/T shifted dense adds in dslab's dtype, j = 0, 1,
    ..., as ``ops/neighbors.py:_windowed_take_bwd`` adds them; the pad rows
    are dropped."""
    nt, s, f = dslab.shape
    dpad = dslab.new_zeros((n + 2 * window, f))
    for j in range(s // tile):
        dpad[j * tile:j * tile + n] += \
            dslab[:, j * tile:(j + 1) * tile].reshape(n, f)
    return dpad[window:window + n]


class WindowGather(torch.autograd.Function):
    """Differentiable windowed gather ``(feats [N, F], lidx [N, K], window,
    tile) -> [N, K, F]``: K2 forward; K3 and the overlap-add backward.  Only
    ``lidx`` and N are saved for the backward, never the features."""

    @staticmethod
    def forward(ctx, feats, lidx, window, tile):
        ctx.save_for_backward(lidx)
        ctx.n, ctx.window, ctx.tile = feats.shape[0], window, tile
        return _gather(feats, lidx, window, tile)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        (lidx,) = ctx.saved_tensors
        # the gradient of a slice of a concatenation is a strided view
        dslab = _dslab(g.contiguous(), lidx, ctx.window, ctx.tile)
        return overlap_add(dslab, ctx.n, ctx.window, ctx.tile), None, None, \
            None
