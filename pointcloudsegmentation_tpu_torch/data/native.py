"""ctypes binding for the native host library (the repository's
``csrc/pointutil.cpp``), the port's own copy of
``pointcloudsegmentation_tpu.data.native``: grid downsampling, radius and
k-NN search and covariance features for the data pipeline, and the
interpolation of the scene eval.

The library is compiled with g++ at first use into the gitignored
``pointcloudsegmentation_tpu_torch/_build/`` (never into ``csrc/``).  A
build or load failure raises: there is no numpy fallback."""
from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

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
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_lib: Optional[ctypes.CDLL] = None


def build(force: bool = False) -> Build:
    """Compile ``csrc/pointutil.cpp`` into ``_build/`` if the library is
    missing or older than its source (or always with ``force``)."""
    return compile_library(["g++"] + CXX_FLAGS, SOURCE, LIB, force)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build().path)
        lib.pcs_grid_downsample.restype = ctypes.c_int
        lib.pcs_grid_downsample.argtypes = [_f32p, ctypes.c_int,
                                            ctypes.c_float, _i32p]
        lib.pcs_radius_neighbors.restype = None
        lib.pcs_radius_neighbors.argtypes = [
            _f32p, ctypes.c_int, _f32p, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, _i32p, _i32p]
        lib.pcs_knn.restype = None
        lib.pcs_knn.argtypes = [_f32p, ctypes.c_int, _f32p, ctypes.c_int,
                                ctypes.c_int, ctypes.c_float, _i32p, _f32p]
        lib.pcs_compute_covars.restype = None
        lib.pcs_compute_covars.argtypes = [_f32p, ctypes.c_int, _i32p,
                                           ctypes.c_int, ctypes.c_float,
                                           _f32p]
        lib.pcs_interpolate_probs.restype = None
        lib.pcs_interpolate_probs.argtypes = [
            _f32p, _f32p, ctypes.c_int, ctypes.c_int, _f32p, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_float, _f32p]
        _lib = lib
    return _lib


def grid_downsample(xyz: np.ndarray, stride: float) -> np.ndarray:
    """Indices of one point per occupied voxel of size ``stride``."""
    lib = _load()
    xyz = np.ascontiguousarray(xyz, np.float32)
    out = np.empty(len(xyz), np.int32)
    kept = lib.pcs_grid_downsample(xyz, len(xyz), stride, out)
    return out[:kept].copy()


def radius_neighbors(xyz: np.ndarray, query: np.ndarray, radius: float,
                     k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Fixed-K nearest in-radius neighbors; returns (idx [nq,k], cnt [nq])."""
    lib = _load()
    xyz = np.ascontiguousarray(xyz, np.float32)
    query = np.ascontiguousarray(query, np.float32)
    idx = np.empty((len(query), k), np.int32)
    cnt = np.empty(len(query), np.int32)
    lib.pcs_radius_neighbors(xyz, len(xyz), query, len(query), radius, k,
                             idx, cnt)
    return idx, cnt


def knn(support: np.ndarray, query: np.ndarray, k: int,
        cell_hint: float = 0.5) -> Tuple[np.ndarray, np.ndarray]:
    """The ``k`` nearest support points of each query: (idx [nq,k],
    squared distances [nq,k])."""
    lib = _load()
    support = np.ascontiguousarray(support, np.float32)
    query = np.ascontiguousarray(query, np.float32)
    idx = np.empty((len(query), k), np.int32)
    d2 = np.empty((len(query), k), np.float32)
    lib.pcs_knn(support, len(support), query, len(query), k, cell_hint,
                idx, d2)
    return idx, d2


def compute_covars(xyz: np.ndarray, query_idx: np.ndarray,
                   radius: float) -> np.ndarray:
    """Trace-normalised 3x3 covariance of each query point's ``radius``
    neighborhood, flattened to [nq, 9]."""
    lib = _load()
    xyz = np.ascontiguousarray(xyz, np.float32)
    query_idx = np.ascontiguousarray(query_idx, np.int32)
    out = np.empty((len(query_idx), 9), np.float32)
    lib.pcs_compute_covars(xyz, len(xyz), query_idx, len(query_idx),
                           radius, out)
    return out


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
