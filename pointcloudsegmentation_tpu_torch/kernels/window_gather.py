"""Windowed slab gather: the Hopper port of the TPU kernel
``pointcloudsegmentation_tpu/ops/pallas/window_gather.py:gather_fwd``.

    out[i, k, :] = feats_padded[(i // T) * T + lidx[i, k]]

where ``feats_padded`` is ``feats`` with W zero rows on each side, T the
tile and W the window; ``lidx`` is slab-local in ``[0, T + 2W)`` (an index
outside that range reads zeros, as the TPU kernel's one-hot rows do).

On a CUDA tensor ``gather_fwd`` launches the kernel in
``csrc/window_gather.cu`` (built with nvcc for sm_90a at first use into
``_build/`` and bound through ctypes) and raises if the build or the launch
fails; on a CPU tensor it runs ``gather_fwd_reference``.  The kernel is a
byte copy and matches the reference exactly for every dtype.  It is bounded
by memory (N*K*F output elements, no arithmetic); the design notes are at the
top of the CUDA source.  No backward is ported: ``gather_fwd`` refuses
inputs that require grad.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import time
from typing import NamedTuple, Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "window_gather.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
_LIB_PATH = os.path.join(BUILD_DIR, "libpcs_window_gather.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class Build(NamedTuple):
    """A build of the kernel library: its path, and for a fresh build the
    seconds nvcc took and its output (the ``-Xptxas -v`` report)."""

    path: str
    seconds: Optional[float] = None
    log: str = ""


_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    """The CUDA toolkit's nvcc at its standard location, else the one on
    the search path."""
    default = "/usr/local/cuda/bin/nvcc"
    return default if os.path.exists(default) else "nvcc"


def build(force: bool = False) -> Build:
    """Compile the kernel library if it is missing or older than its source
    (or always with ``force``).  Raises on failure."""
    if (not force and os.path.exists(_LIB_PATH)
            and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(SOURCE)):
        return Build(_LIB_PATH)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = [_nvcc()] + NVCC_FLAGS + ["-o", tmp, SOURCE]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
    except FileNotFoundError as e:
        raise RuntimeError("nvcc not found: the window-gather kernel is "
                           "built from csrc/window_gather.cu with the CUDA "
                           "toolkit") from e
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, _LIB_PATH)
    return Build(_LIB_PATH, seconds, log)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build().path)
        lib.pcs_window_gather.restype = ctypes.c_int
        lib.pcs_window_gather.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        _lib = lib
    return _lib


def gather_fwd_reference(feats: torch.Tensor, lidx: torch.Tensor,
                         window: int, tile: int) -> torch.Tensor:
    """Plain PyTorch version: zero-pad, then index.  [N, F], [N, K] ->
    [N, K, F]."""
    n = feats.shape[0]
    s = tile + 2 * window
    fp = torch.nn.functional.pad(feats, (0, 0, window, window))
    tile_start = (torch.arange(n, device=lidx.device) // tile) * tile
    ok = (lidx >= 0) & (lidx < s)
    rows = tile_start[:, None] + lidx.clamp(0, s - 1).long()
    out = fp[rows]
    return torch.where(ok[..., None], out, torch.zeros_like(out))


def _check(feats: torch.Tensor, lidx: torch.Tensor, window: int,
           tile: int) -> None:
    if feats.dim() != 2 or lidx.dim() != 2:
        raise ValueError(f"feats must be [N, F] and lidx [N, K], got "
                         f"{tuple(feats.shape)} and {tuple(lidx.shape)}")
    n = feats.shape[0]
    if lidx.shape[0] != n:
        raise ValueError(f"lidx has {lidx.shape[0]} rows, feats {n}")
    if tile <= 0 or window < 0 or n % tile or window % tile:
        raise ValueError(f"need N % tile == 0 and window % tile == 0 "
                         f"(N={n}, tile={tile}, window={window})")
    if lidx.dtype != torch.int32:
        raise TypeError(f"lidx must be int32, got {lidx.dtype}")
    if feats.device != lidx.device:
        raise ValueError(f"feats on {feats.device}, lidx on {lidx.device}")
    if feats.requires_grad:
        raise RuntimeError("gather_fwd has no backward: the gather's "
                           "gradient kernel is not ported yet")


def gather_fwd(feats: torch.Tensor, lidx: torch.Tensor, window: int,
               tile: int) -> torch.Tensor:
    """[N, F] features, [N, K] int32 slab-local indices -> [N, K, F].

    CUDA tensors run the hand-written kernel; CPU tensors the plain version.
    ``gather_fwd.launches`` counts kernel launches."""
    _check(feats, lidx, window, tile)
    if feats.device.type == "cpu":
        return gather_fwd_reference(feats, lidx, window, tile)
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    if not (feats.is_contiguous() and lidx.is_contiguous()):
        raise ValueError("gather_fwd needs contiguous feats and lidx")
    n, f = feats.shape
    k = lidx.shape[1]
    out = torch.empty((n, k, f), dtype=feats.dtype, device=feats.device)
    if out.numel() == 0:
        return out
    lib = _load()
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        err = lib.pcs_window_gather(
            feats.data_ptr(), lidx.data_ptr(), out.data_ptr(), n, k,
            f * feats.element_size(), tile, window, stream)
    if err != 0:
        raise RuntimeError(f"window-gather kernel launch failed: CUDA error "
                           f"{err}")
    gather_fwd.launches += 1
    return out


gather_fwd.launches = 0
