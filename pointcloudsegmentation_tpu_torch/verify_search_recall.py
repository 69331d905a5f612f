"""Neighbor recall of the port's searches against an exact host reference
(the port's counterpart of ``scripts/verify_search_recall.py``).

On seeded room-like clouds (uniform in x and y, flat-ish in z), each
band's fixed-K neighbors from the search are held against the k nearest
in-band points by float64 distance on the host (ties in index order), and
the recall of the (idx, mask) pairs is reported:

- ``band_recall``: the global search, ``ops.search.multi_band_neighbors``
  (one candidate pool of ``cand_k`` per point), held to 0.99;
- ``windowed_band_recall``: the windowed search, the Morton sort and
  ``ops.search.windowed_multi_band_neighbors`` (slab or global selection
  over ``cand_k`` candidates, tile 256, 8 overflow slots per band, chunk
  2048, a tile-shared overflow pool of P, or per-point overflow slots with
  P = 0), held to 0.94.

    python -m pointcloudsegmentation_tpu_torch.verify_search_recall

runs the global contract and the production windowed configuration
(``slab:32:256:256``) on seeds 0 and 1 and prints PASS or FAIL;
``--grid`` adds the selection study, sel_mode (global, slab) x cand_k
(64, 48, 32) at pool 384, and targeted ``sel_mode:cand_k:pool[:window]``
triples (e.g. ``global:64:256``) run only those windowed configurations.
It runs on the card unless ``--device cpu`` is given.  The port selects
exactly, so its recall is that of the JAX search on the CPU, where
``approx_max_k`` is exact; the JAX script's TPU rows include the
approximate selection's losses.
"""
from __future__ import annotations

import argparse
import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .config import require_device
from .ops import morton, search

BANDS = ((0.0, 0.15, 16), (0.1, 0.2, 24), (0.15, 0.25, 16))
GLOBAL_MIN = 0.99
WINDOWED_MIN = 0.94
# the production windowed configuration (sel_mode, cand_k, pool, window)
PRODUCTION = ("slab", 32, 256, 256)


def room_cloud(n: int, seed: int) -> np.ndarray:
    """[n, 3] float32 points: x, y uniform in [-1.5, 1.5], z in [0, 1.5]."""
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    xyz[:, 2] = rng.uniform(0, 1.5, n)  # room-like: flat-ish
    return xyz


@functools.lru_cache(maxsize=4)
def _exact_want(cloud: bytes, n: int) -> List[np.ndarray]:
    """Per band, the exact in-band k nearest of every point of the [n, 3]
    float32 ``cloud`` (float64 distances, no pool truncation, ties to the
    lower index), as sorted ``row * n + col`` keys.  Cached: a grid holds
    every configuration of a seed against the same sorted cloud."""
    x = np.frombuffer(cloud, np.float32).reshape(n, 3).astype(np.float64)
    d2 = sum((x[:, None, c] - x[None, :, c]) ** 2 for c in range(3))
    wants = []
    for mn, mx, k in BANDS:
        band = (d2 <= mx * mx) & (d2 >= mn * mn)
        if mn > 0:
            np.fill_diagonal(band, False)
        rows, cols = np.nonzero(band)
        order = np.lexsort((cols, d2[rows, cols], rows))
        rows, cols = rows[order], cols[order]
        first = np.searchsorted(rows, np.arange(n))
        keep = np.arange(len(rows)) - first[rows] < k
        wants.append(rows[keep].astype(np.int64) * n + cols[keep])
    return wants


def exact_recall(xyz: np.ndarray, found: Sequence[Tuple[np.ndarray,
                                                        np.ndarray]]
                 ) -> List[Tuple[Tuple[float, float, int], float]]:
    """Per band, the share of the exact in-band k nearest (``_exact_want``)
    that the search's valid slots hold, each point's slots counted as a
    set.  ``found``: (idx [n, K], mask [n, K]) per band, global indices
    into ``xyz``.  The JAX script's per-point loop, on whole arrays."""
    n = len(xyz)
    out = []
    wants = _exact_want(np.ascontiguousarray(xyz, np.float32).tobytes(), n)
    for (mn, mx, k), want, (ai, am) in zip(BANDS, wants, found):
        got = np.unique(np.nonzero(am)[0].astype(np.int64) * n
                        + ai[am].astype(np.int64))
        inter = int(np.isin(got, want, assume_unique=True).sum())
        out.append(((mn, mx, k), inter / max(len(want), 1)))
    return out


def band_recall(n: int = 8192, cand_k: int = 96, seed: int = 0,
                device="cuda"):
    """Recall of the global search per band."""
    xyz = room_cloud(n, seed)
    x = torch.from_numpy(xyz).to(device)
    res = search.multi_band_neighbors(
        x, torch.ones(n, dtype=torch.bool, device=device), BANDS,
        cand_k=cand_k, chunk=1024)
    return exact_recall(xyz, [(nb.idx.cpu().numpy(), nb.mask.cpu().numpy())
                              for nb in res])


def windowed_band_recall(n: int = 8192, cand_k: int = 64, seed: int = 0,
                         sel_mode: str = "global", ov_pool_size: int = 0,
                         window: int = 256, device="cuda"):
    """Recall of the windowed search per band, on the Morton-sorted
    cloud (global indices of the sorted order)."""
    x = torch.from_numpy(room_cloud(n, seed)).to(device)
    xs, ms, _ = morton.sort_block(
        x, torch.ones(n, dtype=torch.bool, device=device), 0.0375, 3.0)
    res = search.windowed_multi_band_neighbors(
        xs, ms, BANDS, tile=256, window=window, cand_k=cand_k, ov_slots=8,
        chunk=2048, sel_mode=sel_mode, ov_pool_size=ov_pool_size)
    return exact_recall(xs.cpu().numpy(),
                        [(wn.global_idx.cpu().numpy(),
                          wn.mask.cpu().numpy()) for wn in res])


def _configs(args) -> List[Tuple[str, int, int, int]]:
    """The windowed configurations the arguments ask for; exits on a
    malformed one."""
    if args.grid and args.configs:
        raise SystemExit("--grid cannot be combined with targeted "
                         "sel_mode:cand_k:pool configs — pick one")
    if args.grid:
        configs = [(m, ck, 384, 256) for m in ("global", "slab")
                   for ck in (64, 48, 32)]
    elif args.configs:
        configs = []
        for t in args.configs:
            parts = t.split(":")
            if len(parts) not in (3, 4):
                raise SystemExit(
                    f"bad config {t!r}: expected sel_mode:cand_k:pool"
                    "[:window] (e.g. slab:32:256 or slab:32:256:128)")
            m, ck, pool = parts[:3]
            win = parts[3] if len(parts) == 4 else "256"
            if m not in ("global", "slab"):
                raise SystemExit(f"bad sel_mode in {t!r}")
            try:
                ck, pool, win = int(ck), int(pool), int(win)
            except ValueError:
                raise SystemExit(
                    f"bad config {t!r}: cand_k/pool/window must be ints")
            configs.append((m, ck, pool, win))
    else:
        configs = [PRODUCTION]
    return configs


def main(argv=None) -> None:
    """Default: the global-search contract + the production windowed
    config.  --grid sweeps sel_mode x cand_k at pool 384 (A/B data for
    choosing defaults); targeted ``sel_mode:cand_k:pool[:window]`` triples
    validate a candidate default without the grid and skip the
    global-contract rows.  Exits 0 on PASS, 1 on FAIL."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("configs", nargs="*",
                   help="sel_mode:cand_k:pool[:window] triples")
    p.add_argument("--grid", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    configs = _configs(args)
    device = require_device(args.device)
    ok = True
    if args.configs:
        print("targeted configs skip the global-contract rows")
    else:
        for seed in (0, 1):
            for band, r in band_recall(seed=seed, device=device):
                status = "OK" if r >= GLOBAL_MIN else "FAIL"
                ok &= r >= GLOBAL_MIN
                print(f"global seed={seed} band={band}: recall={r:.4f} "
                      f"{status}", flush=True)
    for sel_mode, ck, pool, win in configs:
        for seed in (0, 1):
            for band, r in windowed_band_recall(seed=seed, cand_k=ck,
                                                sel_mode=sel_mode,
                                                ov_pool_size=pool,
                                                window=win, device=device):
                status = "OK" if r >= WINDOWED_MIN else "FAIL"
                ok &= r >= WINDOWED_MIN
                print(f"windowed[{sel_mode},ck={ck},P={pool},W={win}] "
                      f"seed={seed} band={band}: recall={r:.4f} {status}",
                      flush=True)
    print("PASS" if ok else "FAIL")
    raise SystemExit(0 if ok else 1)


if __name__ == "__main__":
    main()
