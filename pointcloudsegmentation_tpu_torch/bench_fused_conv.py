"""Microbench of the fused window-conv kernel (K1) against the unfused
``PointNetConvFast`` path, on one flagship conv at full width (the port's
counterpart of ``scripts/bench_fused_conv.py``).

    python -m pointcloudsegmentation_tpu_torch.bench_fused_conv --level 0|1 \
        [--reps 16]

Level 0: N=8192 points, F=64 input features, radius 0.15, K=32 slots,
dims (8, 8, 16, 32); level 1: N=4096, F=128, radius 0.45, K=32, dims (16,
16, 32, 64); both tile = window = 256 (slab 768), bf16 compute with float32
weights drawn from ``torch.Generator`` seed 0.  The block is the port's
synthetic S3DIS room (seed 0), Morton-sorted and searched with the JAX
script's windowed settings.  Arms, each timed in milliseconds per call with
CUDA events around ``--reps`` eager calls (default 16; host dispatch
included):

  unfused fwd      ``PointNetConvFast`` on the windowed neighborhood with
                   the search's sxyz (the production conv),
  unfused fwd+bwd  the same plus the gradient of its sum in the features,
  fused fwd        the per-point projections (matmuls) + K1, with the
                   weights packed once outside the timed calls.

Then the cross-check: K1 (windowed slots only) against ``PointNetConvFast``
with the layer's xyz fold on the same windowed slots without the overflow
ones; the max abs difference is printed.  The card's name and power limit
are printed beside the times.  With ``--device cpu`` only the cross-check
runs (K1's plain version): a CPU run gives no device time.
"""
from __future__ import annotations

import argparse
from typing import Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .data import toy
from .kernels import fused_conv as fc
from .models.fast_conv import PointNetConvFast, split_xyz
from .models.layers import init_glorot_
from .ops import morton, search
from .ops.types import WindowedNeighborhood

TILE = WINDOW = 256
LEVELS = {0: dict(n=8192, f=64, radius=0.15, k=32, dims=(8, 8, 16, 32)),
          1: dict(n=4096, f=128, radius=0.45, k=32, dims=(16, 16, 32, 64))}


class Bench(NamedTuple):
    """One level's inputs: sorted xyz [N, 3], the windowed neighborhood and
    the search's sxyz, features [N, F], the conv and its radius."""

    xs: torch.Tensor
    wn: WindowedNeighborhood
    sxyz: torch.Tensor
    feats: torch.Tensor
    conv: PointNetConvFast
    radius: float


def setup(level: int, device="cuda", n: int = None,
          dtype: torch.dtype = torch.bfloat16) -> Bench:
    """Level ``level``'s block, search, features and conv on ``device``;
    ``n`` cuts the point count (tests), ``dtype`` is the compute dtype."""
    spec = LEVELS[level]
    n = n or spec["n"]
    b = toy.synthetic_room_block(np.random.RandomState(0), n)
    xyz = torch.from_numpy(b["xyz"]).to(device)
    mask = torch.ones(n, dtype=torch.bool, device=device)
    xs, ms, _ = morton.sort_block(xyz, mask, 0.0375, 3.0)
    (pair,) = search.windowed_multi_band_neighbors(
        xs, ms, ((0.0, spec["radius"], spec["k"]),), tile=TILE,
        window=WINDOW, cand_k=32, ov_slots=8, ov_pool_size=256,
        return_sxyz=True, chunk=2048, sel_mode="slab")
    wn, sxyz = pair
    gen = torch.Generator().manual_seed(0)
    feats = torch.randn((n, spec["f"]), generator=gen).to(device)
    dims = spec["dims"]
    conv = PointNetConvFast(spec["f"], dims[:-1], dims[-1], dtype=dtype)
    init_glorot_(conv, torch.Generator().manual_seed(0))
    return Bench(xs, wn, sxyz, feats, conv.to(device), spec["radius"])


def fused_arm(b: Bench, dtype: torch.dtype = None
              ) -> Callable[[], Tuple]:
    """The fused arm split as the JAX script splits it: the weights (in the
    compute dtype, or ``dtype``), the hi/mid coordinate columns, the float32
    xyzc and the windowed indices with -1 at invalid slots are packed once;
    the returned function does the per-call work, projecting the features
    into the padded stream ``[nbr_proj ‖ hi ‖ mid]`` and the centre
    projections, and returns K1's arguments."""
    w = fc.pack_fused_conv(b.conv, b.radius, dtype)
    cdt = w.wnbr.dtype
    hi, mid = split_xyz(b.xs, cdt)
    xyzc = F.pad(b.xs, (0, 1))
    lidxm = torch.where(b.wn.wmask, b.wn.lidx, torch.full_like(b.wn.lidx, -1))

    def inputs() -> Tuple:
        ft = b.feats.to(cdt)
        fpx = torch.cat([ft @ w.wnbr, hi, mid], dim=-1)
        cen = ft @ w.wcen + w.bcen
        return (F.pad(fpx, (0, 0, b.wn.window, b.wn.window)), cen, xyzc,
                lidxm, w.wsx, w.whids, b.wn.window, b.wn.tile, w.dims)
    return inputs


@torch.no_grad()
def cross_check(b: Bench) -> Tuple[float, float]:
    """(max abs difference, largest |output|) between the fused arm and
    ``PointNetConvFast`` with the xyz fold, both on the windowed slots only
    (no overflow), with the conv's any-valid floor applied to the fused
    output; float32."""
    n = b.feats.shape[0]
    wn = b.wn
    wn_only = WindowedNeighborhood(
        lidx=wn.lidx, wmask=wn.wmask,
        ov_idx=wn.lidx.new_zeros((n, 0)),
        ov_mask=wn.wmask.new_zeros((n, 0)), window=wn.window, tile=wn.tile)
    want = b.conv(None, b.feats, wn_only, xyz=b.xs,
                  inv_rescale=1.0 / b.radius).float()
    best = fc.fused_window_conv_fwd(*fused_arm(b)())
    got = torch.where(wn.wmask.any(dim=1)[:, None], best.float(),
                      torch.zeros_like(want))
    return (got - want).abs().max().item(), want.abs().max().item()


def time_arms(b: Bench, iters: int = 20) -> Dict[str, float]:
    """Milliseconds per call of the three arms (CUDA events, eager)."""
    from .utils.timing import cuda_ms

    sx = b.sxyz / b.radius
    feats = b.feats.detach().requires_grad_()

    def fwd_bwd():
        return torch.autograd.grad(b.conv(sx, feats, b.wn).float().sum(),
                                   feats)

    with torch.no_grad():
        ms = {"unfused fwd": cuda_ms(lambda: b.conv(sx, b.feats, b.wn),
                                     iters)}
    ms["unfused fwd+bwd"] = cuda_ms(fwd_bwd, iters)
    inputs = fused_arm(b)
    with torch.no_grad():
        ms["fused fwd"] = cuda_ms(
            lambda: fc.fused_window_conv_fwd(*inputs()), iters)
    return ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--level", type=int, default=0, choices=sorted(LEVELS))
    ap.add_argument("--reps", type=int, default=16,
                    help="timed calls of each arm")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    b = setup(args.level, args.device)
    n, k = b.wn.lidx.shape
    dims = LEVELS[args.level]["dims"]
    where = "the CPU (K1's plain version; no times)"
    if b.feats.is_cuda:
        from .utils.timing import card
        where = card()
        for arm, ms in time_arms(b, args.reps).items():
            print(f"{arm:16s} N={n} K={k} dims={dims}: {ms:.4f} ms [{where}]")
    err, scale = cross_check(b)
    print(f"fused vs unfused (windowed slots, bf16): max abs diff {err:.4f} "
          f"(largest |output| {scale:.4f}) [{where}]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
