"""Builds of the port's native libraries into the gitignored ``_build/``.

Each CUDA kernel library is one source under ``csrc/`` compiled by nvcc for
sm_90a into a shared library with a plain C interface, loaded with ctypes
at first use; ``build_all`` starts one nvcc per source, all at once.  A
build raises on failure: nothing falls back."""
from __future__ import annotations

import ctypes
import os
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, NamedTuple, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = {name: os.path.join(_PKG, "csrc", f"{name}.cu")
           for name in ("window_gather", "window_dslab", "fused_window_conv")}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class Build(NamedTuple):
    """A build of one library: its path, and for a fresh build the seconds
    the compiler took and its output (nvcc's ``-Xptxas -v`` report)."""

    path: str
    seconds: Optional[float] = None
    log: str = ""


_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    """The CUDA toolkit's nvcc at its standard location, else the one on
    the search path."""
    default = "/usr/local/cuda/bin/nvcc"
    return default if os.path.exists(default) else "nvcc"


def compile_library(cmd: List[str], source: str, lib: str,
                    force: bool = False) -> Build:
    """Run compiler command ``cmd`` (without its output) to build ``lib``
    from ``source`` if ``lib`` is missing or older than ``source`` (or
    always with ``force``).  The output goes to a temporary name and is
    renamed into place, so a concurrent process never loads a half-written
    library.  Raises on failure."""
    if (not force and os.path.exists(lib)
            and os.path.getmtime(lib) >= os.path.getmtime(source)):
        return Build(lib)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = cmd + ["-o", tmp, source]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
    except FileNotFoundError as e:
        raise RuntimeError(f"{cmd[0]} not found: {lib} is built from "
                           f"{source}") from e
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"build failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, lib)
    return Build(lib, seconds, log)


def build(name: str, force: bool = False) -> Build:
    """Compile kernel library ``name`` (a key of ``SOURCES``) with nvcc."""
    return compile_library([_nvcc()] + NVCC_FLAGS, SOURCES[name],
                           os.path.join(BUILD_DIR, f"libpcs_{name}.so"),
                           force)


def build_all(force: bool = False) -> Dict[str, Build]:
    """Build every kernel library, one nvcc per source, all at once."""
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        futures = {name: pool.submit(build, name, force) for name in SOURCES}
        return {name: f.result() for name, f in futures.items()}


def load(name: str, entries: Dict[str, list]) -> ctypes.CDLL:
    """The kernel library ``name``, built if needed, with each entry point
    of ``entries`` (symbol -> ctypes argtypes) bound to its argtypes and an
    int (cudaError_t) result."""
    if name not in _libs:
        lib = ctypes.CDLL(build(name).path)
        for symbol, argtypes in entries.items():
            fn = getattr(lib, symbol)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
        _libs[name] = lib
    return _libs[name]
