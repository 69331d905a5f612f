"""Fused windowed PointNet conv, forward only: the Hopper port of the TPU
kernel ``pointcloudsegmentation_tpu/ops/pallas/fused_conv.py:
fused_window_conv_fwd`` (K1).

For every point i of tile t = i // T and each of its K windowed slots::

    g      = fpx[t*T + lidx[i, k]]            # [nbr_proj ‖ xyz_hi ‖ xyz_mid]
    xyz_j  = g[hi] + g[mid]                   # float32
    sx     = cdt(xyz_j - xyz_i)
    base   = g[:ΣD] + cen[i] + sx @ wsx       # float32
    a_0    = base[D_0 block];  h_0 = cdt(relu(a_0))
    a_l    = base[D_l block] + [h_0 ‖ … ‖ h_{l-1}] @ whids[l-1]
    out[i] = cdt(max over k with lidx[i, k] >= 0 of a_last)   # else -1e30

with products accumulated in float32, hidden states rounded to the compute
dtype ``cdt`` after the relu, and the output rounded once.  ``lidx`` is
slab-local: an index outside ``[0, T + 2W)`` reads a zero row (as the TPU
kernel's one-hot row does) and only a negative index masks the slot.  The
result is the masked max over the windowed slots; the caller merges any
overflow slots and applies the any-valid floor.

On CUDA tensors ``fused_window_conv_fwd`` launches ``csrc/
fused_window_conv.cu`` (nvcc, sm_90a, built at first use into ``_build/``,
bound through ctypes) and raises if the build or the launch fails; on CPU
tensors it runs the plain version ``fused_window_conv_reference``.  There
is no backward (the JAX package has none): the entry point refuses inputs
that require grad.  In bfloat16 the kernel runs 16 slots at a time through
the tensor cores (``mma.sync``), which takes each layer's hidden and output
widths in tiles of 8 columns: at most ``MAX_TILES`` tiles of hidden state
(all layers but the last) and of output, and ``fpx`` and ``cen`` 4-byte
aligned.  Kernel and plain version sum the products in different orders,
so they agree to float32 rounding, and in bfloat16 up to the hidden
states' roundings that this moves across a rounding boundary.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from . import _build

NEG = -1e30
MAX_LAYERS = 8                 # csrc/fused_window_conv.cu's kMaxLayers
MAX_TILES = 16                 # ... and its kMaxTiles (8 columns a tile)
_I, _P = ctypes.c_int, ctypes.c_void_p
# fpx, cen, xyzc, lidx, wsx, whids (host array of pointers), out, dims
# (host int array), n_layers, n, k, tile, window, dtype, stream
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _offs(dims: Sequence[int]) -> Tuple[int, ...]:
    o = [0]
    for d in dims:
        o.append(o[-1] + d)
    return tuple(o)


def window_conv_slots(fpx: torch.Tensor, cen: torch.Tensor,
                      xyzc: torch.Tensor, lidx: torch.Tensor,
                      wsx: torch.Tensor, whids: Sequence[torch.Tensor],
                      window: int, tile: int,
                      dims: Sequence[int]) -> torch.Tensor:
    """Every slot's last-layer activation before the masked max, float32
    [N, K, Dout], with K1's arithmetic (see the module docstring)."""
    n, k = lidx.shape
    sumd = cen.shape[-1]
    s = tile + 2 * window
    cdt = fpx.dtype
    offs = _offs(dims)
    tile_start = (torch.arange(n, device=lidx.device) // tile) * tile
    in_slab = (lidx >= 0) & (lidx < s)
    rows = torch.where(in_slab, tile_start[:, None] + lidx,
                       torch.full_like(lidx, fpx.shape[0])).long()
    g = torch.cat([fpx, fpx.new_zeros((1, fpx.shape[1]))])[rows].float()
    xyz_j = g[..., sumd:sumd + 3] + g[..., sumd + 3:sumd + 6]
    sx = (xyz_j - xyzc[:, None, :3]).to(cdt).float()
    base = g[..., :sumd] + cen.float()[:, None, :] + sx @ wsx.float()
    hs = []
    for i in range(len(dims)):
        a = base[..., offs[i]:offs[i + 1]]
        if i > 0:
            a = a + torch.cat(hs, dim=-1).float() @ whids[i - 1].float()
        if i < len(dims) - 1:
            hs.append(torch.relu(a).to(cdt))
    return a


def fused_window_conv_reference(fpx, cen, xyzc, lidx, wsx, whids, window,
                                tile, dims) -> torch.Tensor:
    """Plain PyTorch version of K1: the slots' activations, masked
    (negative index -> -1e30), maxed over K, rounded once -> [N, Dout]."""
    out = window_conv_slots(fpx, cen, xyzc, lidx, wsx, whids, window, tile,
                            dims)
    neg = torch.where((lidx >= 0)[..., None], out, torch.full_like(out, NEG))
    return neg.amax(dim=1).to(fpx.dtype)


def _check(fpx, cen, xyzc, lidx, wsx, whids, window, tile, dims) -> None:
    for name, x in (("fpx", fpx), ("cen", cen), ("xyzc", xyzc),
                    ("wsx", wsx)) + tuple(
                        (f"whids[{i}]", w) for i, w in enumerate(whids)):
        if x.requires_grad:
            raise RuntimeError(f"fused_window_conv_fwd has no backward: "
                               f"{name} requires grad")
        if x.device != lidx.device:
            raise ValueError(f"{name} on {x.device}, lidx on {lidx.device}")
    if lidx.dim() != 2 or lidx.dtype != torch.int32 or lidx.shape[1] == 0:
        raise TypeError(f"lidx must be int32 [N, K] with K > 0, got "
                        f"{lidx.dtype} {tuple(lidx.shape)}")
    n = lidx.shape[0]
    if tile <= 0 or window < 0 or n % tile:
        raise ValueError(f"need tile > 0, window >= 0 and N % tile == 0 "
                         f"(N={n}, tile={tile}, window={window})")
    dims = tuple(dims)
    if not 1 <= len(dims) <= MAX_LAYERS or min(dims) <= 0:
        raise ValueError(f"dims must be 1 to {MAX_LAYERS} positive widths, "
                         f"got {dims}")
    if len(whids) != len(dims) - 1:
        raise ValueError(f"{len(whids)} whids for {len(dims)} layers")
    sumd = sum(dims)
    offs = _offs(dims)
    want = {"fpx": (fpx, (n + 2 * window, sumd + 6)),
            "cen": (cen, (n, sumd)), "xyzc": (xyzc, (n, 4)),
            "wsx": (wsx, (3, sumd))}
    for i in range(1, len(dims)):
        want[f"whids[{i - 1}]"] = (whids[i - 1], (offs[i], dims[i]))
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got "
                             f"{list(x.shape)}")
    if fpx.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_window_conv_fwd takes "
                        f"{sorted(map(str, _DTYPE_CODES))}, got {fpx.dtype}")
    for name, x in [("cen", cen), ("wsx", wsx)] + [
            (f"whids[{i}]", w) for i, w in enumerate(whids)]:
        if x.dtype != fpx.dtype:
            raise TypeError(f"{name} is {x.dtype}, fpx {fpx.dtype}")
    if xyzc.dtype != torch.float32:
        raise TypeError(f"xyzc must be float32, got {xyzc.dtype}")
    if lidx.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {lidx.device}")


def _check_kernel(fpx: torch.Tensor, cen: torch.Tensor,
                  dims: Sequence[int]) -> None:
    """What the bfloat16 kernel takes beyond the plain version: at most
    ``MAX_TILES`` tiles of 8 columns of hidden state and of output, and
    ``fpx`` and ``cen`` 4-byte aligned (their column pairs load as one
    word)."""
    if fpx.dtype != torch.bfloat16:
        return
    tiles = [-(-d // 8) for d in dims]
    if sum(tiles[:-1]) > MAX_TILES or tiles[-1] > MAX_TILES:
        raise ValueError(f"the bfloat16 kernel takes at most {MAX_TILES} "
                         f"tiles of 8 columns of hidden state and of output, "
                         f"got dims {tuple(dims)}")
    for name, x in (("fpx", fpx), ("cen", cen)):
        if x.data_ptr() % 4:
            raise ValueError(f"the bfloat16 kernel needs {name} 4-byte "
                             f"aligned")


def fused_window_conv_fwd(fpx: torch.Tensor, cen: torch.Tensor,
                          xyzc: torch.Tensor, lidx: torch.Tensor,
                          wsx: torch.Tensor, whids: Sequence[torch.Tensor],
                          window: int, tile: int,
                          dims: Sequence[int]) -> torch.Tensor:
    """K1, with the JAX signature and layout.

    fpx:  [N + 2W, ΣD + 6]  padded per-point stream [nbr_proj ‖ xyz_hi ‖
          xyz_mid], compute dtype (float32 or bfloat16).
    cen:  [N, ΣD]           center projections (biases folded in).
    xyzc: [N, 4]            float32 coordinates (column 3 unused).
    lidx: [N, K]            int32 slab-local indices, -1 = invalid slot.
    wsx:  [3, ΣD]           sxyz kernels, pre-scaled by 1/rescale.
    whids: per layer l >= 1, [ΣD_{<l}, D_l] hidden-growth kernels.
    Returns [N, Dout] in the compute dtype: the masked max over the K
    slots (-1e30 where no slot is valid).  ``fused_window_conv_fwd.
    launches`` counts kernel launches."""
    whids = tuple(whids)
    _check(fpx, cen, xyzc, lidx, wsx, whids, window, tile, dims)
    if lidx.device.type == "cpu":
        return fused_window_conv_reference(fpx, cen, xyzc, lidx, wsx, whids,
                                           window, tile, dims)
    tensors = (fpx, cen, xyzc, lidx, wsx) + whids
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("fused_window_conv_fwd needs contiguous inputs")
    _check_kernel(fpx, cen, dims)
    n, k = lidx.shape
    out = torch.empty((n, dims[-1]), dtype=fpx.dtype, device=fpx.device)
    lib = _build.load("fused_window_conv",
                      {"pcs_fused_window_conv": _ARGTYPES})
    ptrs = (ctypes.c_void_p * MAX_LAYERS)(*[w.data_ptr() for w in whids])
    cdims = (ctypes.c_int * MAX_LAYERS)(*dims)
    with torch.cuda.device(fpx.device):
        err = lib.pcs_fused_window_conv(
            fpx.data_ptr(), cen.data_ptr(), xyzc.data_ptr(), lidx.data_ptr(),
            wsx.data_ptr(), ptrs, out.data_ptr(), cdims, len(dims), n, k,
            tile, window, _DTYPE_CODES[fpx.dtype],
            torch.cuda.current_stream(fpx.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused window-conv kernel launch failed: CUDA "
                           f"error {err}")
    fused_window_conv_fwd.launches += 1
    return out


fused_window_conv_fwd.launches = 0


class FusedConvWeights(NamedTuple):
    """A ``PointNetConvFast``'s weights in K1's layout, compute dtype:
    ``wnbr``/``wcen`` [F, ΣD] and ``bcen`` [ΣD] for the projections, ``wsx``
    [3, ΣD] divided by the rescale, ``whids`` per layer l >= 1."""

    wnbr: torch.Tensor
    wcen: torch.Tensor
    bcen: torch.Tensor
    wsx: torch.Tensor
    whids: Tuple[torch.Tensor, ...]
    dims: Tuple[int, ...]


@torch.no_grad()
def pack_fused_conv(conv, rescale: float,
                    dtype: Optional[torch.dtype] = None) -> FusedConvWeights:
    """Pack ``conv`` (a ``models.fast_conv.PointNetConvFast``) for K1, as
    ``scripts/bench_fused_conv.py`` packs the flax layer: per-layer kernels
    (``[in, out]``, the transposed ``nn.Linear`` weights) concatenated
    along the output for the projections and ``wsx``, along the input for
    each layer's hidden-growth kernel; ``wsx`` divided by ``rescale`` in
    float32; then all cast to ``dtype`` (default: the conv's compute
    dtype)."""
    dims = tuple(conv.dims)
    cdt = dtype or conv.fc_0_nbr.compute_dtype or torch.float32
    fc = lambda name: getattr(conv, name).weight.t()  # noqa: E731
    layers = range(len(dims))

    def cat(xs, dim, scale=1.0):
        return (torch.cat(xs, dim=dim) / scale).contiguous().to(cdt)

    return FusedConvWeights(
        wnbr=cat([fc(f"fc_{i}_nbr") for i in layers], -1),
        wcen=cat([fc(f"fc_{i}_cen") for i in layers], -1),
        bcen=cat([getattr(conv, f"fc_{i}_cen").bias for i in layers], -1),
        wsx=cat([fc(f"fc_{i}_sxyz") for i in layers], -1, rescale),
        whids=tuple(cat([fc(f"fc_{i}_h{j}") for j in range(i)], 0)
                    for i in range(1, len(dims))),
        dims=dims)

