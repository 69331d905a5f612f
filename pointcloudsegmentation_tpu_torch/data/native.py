"""ctypes binding for the native host library (the repository's
``csrc/pointutil.cpp``), the port's own copy of
``pointcloudsegmentation_tpu.data.native`` for what the port calls.

The library is compiled with g++ at first use into the gitignored
``pointcloudsegmentation_tpu_torch/_build/`` (never into ``csrc/``).  A
build or load failure raises: there is no numpy fallback."""
from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from ..kernels._build import BUILD_DIR, Build, compile_library

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "csrc", "pointutil.cpp")
LIB = os.path.join(BUILD_DIR, "libpcspointutil.so")
# csrc/Makefile's flags
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-pthread",
             "-Wall", "-shared"]

_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_lib: Optional[ctypes.CDLL] = None


def build(force: bool = False) -> Build:
    """Compile ``csrc/pointutil.cpp`` into ``_build/`` if the library is
    missing or older than its source (or always with ``force``)."""
    return compile_library(["g++"] + CXX_FLAGS, SOURCE, LIB, force)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build().path)
        lib.pcs_interpolate_probs.restype = None
        lib.pcs_interpolate_probs.argtypes = [
            _f32p, _f32p, ctypes.c_int, ctypes.c_int, _f32p, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_float, _f32p]
        _lib = lib
    return _lib


def interpolate_probs(sxyz: np.ndarray, sprobs: np.ndarray,
                      qxyz: np.ndarray, k: int, ratio: float,
                      cell_hint: float = 0.5) -> np.ndarray:
    """Gaussian-weighted k-NN interpolation of per-point class probabilities
    ``sprobs`` [M, C] at ``sxyz`` [M, 3] onto the queries ``qxyz`` [Q, 3]
    (hash-grid search with cells of ``cell_hint``) -> [Q, C] float32."""
    lib = _load()
    sxyz = np.ascontiguousarray(sxyz, np.float32)
    sprobs = np.ascontiguousarray(sprobs, np.float32)
    qxyz = np.ascontiguousarray(qxyz, np.float32)
    out = np.empty((len(qxyz), sprobs.shape[1]), np.float32)
    lib.pcs_interpolate_probs(sxyz, sprobs, len(sxyz), sprobs.shape[1],
                              qxyz, len(qxyz), k, ratio, cell_hint, out)
    return out
