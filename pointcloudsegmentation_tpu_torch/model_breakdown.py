"""Component times of the flagship on one CUDA card (the port's
counterpart of ``scripts/model_breakdown.py``).

    python -m pointcloudsegmentation_tpu_torch.model_breakdown \
        [--which all|conv|convf32|search|sort|model] [--device cuda]

Rows, each under the JAX script's label and at its shapes (8192 points
of ``toy.synthetic_room_block``, seed 0, Morton-sorted):

- ``conv`` / ``convf32``: ``PointNetConvFast(64, (8, 8, 16), 32)`` in
  bf16 / float32 (Glorot weights from ``torch.Generator`` seed 0) on the
  level-0 band's windowed neighborhood (cand_k 64, 12 overflow slots,
  search chunk 2048; the window-gather kernels K2 forward and K3 backward)
  and on its plain global-index view, forward and forward+backward in the
  features;
- ``search``: the 4-band windowed search, then the global one.  The
  JAX script times the windowed search at three ``recall_target``s of
  ``approx_max_k``; the port selects exactly, so it has one windowed row,
  labelled ``rt=1 (exact)``;
- ``sort``: the Morton sort with its features and the inverse
  permutation;
- ``model`` (not in ``all``, as in JAX): the flagship at full width
  (``Trainer``, search chunk 2048, bf16, weights from seed 0) on one
  ``toy_batches(kind="room")`` batch of 4 blocks: the Morton sort and
  pyramid of one block, its forward (``train=False``), its forward and
  backward in the parameters (the sum of the logits), and the 4-block
  train step chained (2 warm steps, 10 timed, one host read).

The timer is the port's ``microbench`` (chained calls between CUDA
events, less its baseline, beside device-only CUDA-graph ms where the op
can be captured); ``--device cpu`` times with the host clock (tests
only)."""
from __future__ import annotations

import argparse
import time
from typing import List

import numpy as np
import torch

from . import microbench as mb
from .config import require_device, s3dis_config
from .data import toy
from .data.provider import to_device
from .models.fast_conv import PointNetConvFast
from .models.layers import init_glorot_
from .ops import hierarchy as hier
from .ops import morton, search
from .train.loop import Trainer
from .utils.timing import card

BANDS = ((0.0, 0.15, 32), (0.15, 0.2, 24), (0.1, 0.15, 16), (0.0, 0.1, 16))
STEP_WARMUP, STEP_REPS = 2, 10


def sorted_cloud(n=8192, device="cuda"):
    """A synthetic room of ``n`` points (seed 0), every point valid,
    Morton-sorted: (xyz [n, 3], mask [n])."""
    b = toy.synthetic_room_block(np.random.RandomState(0), n)
    xyz = torch.from_numpy(b["xyz"]).to(device)
    mask = torch.ones(n, dtype=torch.bool, device=device)
    xs, ms, _ = morton.sort_block(xyz, mask, 0.0375, 3.0)
    return xs, ms


def conv_cases(bf16: bool, device="cuda", n=8192, conv=None
               ) -> List[mb.Case]:
    """JAX ``bench_conv`` (``scripts/model_breakdown.py:41-72``); ``conv``
    replaces the seeded layer (a test loads JAX weights into one)."""
    xs, ms = sorted_cloud(n, device)
    ((wn, sxyz),) = search.windowed_multi_band_neighbors(
        xs, ms, ((0.0, 0.15, 32),), cand_k=64, ov_slots=12,
        return_sxyz=True, chunk=2048)
    plain = wn.to_neighborhood()
    feats = torch.randn((n, 64), generator=mb.seeded(device), device=device)
    if conv is None:
        conv = PointNetConvFast(64, (8, 8, 16), 32,
                                dtype=torch.bfloat16 if bf16 else None)
        init_glorot_(conv, torch.Generator().manual_seed(0))
    conv = conv.to(device)
    io = dict(xs=xs, ms=ms, sxyz=sxyz, feats=feats, windowed=wn,
              plain=plain, conv=conv)
    cases = []
    for label, nbr in (("windowed", wn), ("plain", plain)):
        out = lambda f, nbr=nbr: conv(sxyz, f, nbr).float()  # noqa: E731
        cases += [
            mb.Case(f" conv fwd      [{label}] N={n} K+Ko={nbr.k}",
                    torch.no_grad()(
                        lambda c, out=out: out(feats + c * 1e-9)), io, 16),
            mb.Case(f" conv fwd+bwd  [{label}] N={n} K+Ko={nbr.k}",
                    lambda c, out=out: mb.grad_of_sum(out,
                                                       feats + c * 1e-9),
                    io, 16)]
    return cases


def search_cases(device="cuda", n=8192) -> List[mb.Case]:
    """JAX ``bench_search`` (``scripts/model_breakdown.py:75-99``)."""
    xs, ms = sorted_cloud(n, device)
    io = dict(xs=xs, ms=ms)
    return [
        mb.Case(f" windowed_multi_band rt=1 (exact) 4 bands N={n}",
                lambda c: search.windowed_multi_band_neighbors(
                    xs + c * 1e-9, ms, BANDS, cand_k=64, ov_slots=12,
                    chunk=2048, return_sxyz=True), io, 8),
        mb.Case(f" global multi_band (production) 4 bands N={n}",
                lambda c: search.multi_band_neighbors(
                    xs + c * 1e-9, ms, BANDS, cand_k=64, chunk=2048,
                    return_sxyz=True), io, 8)]


def sort_cases(device="cuda", n=8192) -> List[mb.Case]:
    """JAX ``bench_sort`` (``scripts/model_breakdown.py:102-116``)."""
    b = toy.synthetic_room_block(np.random.RandomState(0), n)
    xyz = torch.from_numpy(b["xyz"]).to(device)
    feats = torch.randn((n, 12), generator=mb.seeded(device), device=device)
    mask = torch.ones(n, dtype=torch.bool, device=device)

    def srt(c):
        xs, _, order, fs = morton.sort_block(xyz + c * 1e-9, mask, 0.0375,
                                             3.0, feats)
        return xs, fs, morton.inverse_permutation(order)

    return [mb.Case(f" morton sort+inv N={n}", srt,
                    dict(xyz=xyz, feats=feats, mask=mask), 16)]


def model_setup(device="cuda", n=8192, **overrides):
    """The flagship at ``bench.py``'s shape (caps 4096/1024, 12 features,
    search chunk 2048), weights from seed 0, and one batch of 4 room
    blocks (seed 0) on the device: (trainer, state, batch).
    ``overrides`` go to ``s3dis_config`` (a test's smaller model)."""
    cfg = s3dis_config(**{**dict(data_num_points=n, data_caps=(4096, 1024),
                                 data_feat_dim=12), **overrides})
    trainer = Trainer(cfg, device, search_chunk=2048)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    batch = to_device(next(toy.toy_batches(
        1, batch_size=4, num_points=n, kind="room",
        num_classes=cfg.data.num_classes, feat_dim=cfg.data.feat_dim)),
        device)
    return trainer, state, batch


def model_cases(trainer: Trainer, state, batch) -> List[mb.Case]:
    """JAX ``bench_model``'s per-block rows (``scripts/model_breakdown.py:
    140-169``) on block 0 of ``batch`` with ``state``'s weights."""
    model = trainer.bind(state)
    params = list(model.parameters())
    d = trainer.cfg.data
    xyz, feats, mask = batch["xyz"][0], batch["feats"][0], batch["mask"][0]

    def pyr(c):
        xs, ms, _ = morton.sort_block(xyz + c * 1e-9, mask,
                                      d.voxel_sizes[0] / 4, d.block_size)
        p = hier.build_pyramid(xs, ms, d.voxel_sizes, d.caps, d.block_size)
        return [lv.xyz for lv in p.levels] + list(p.seg)

    def logits(c):
        return model(xyz, feats + c * 1e-9, mask, train=False).float()

    def fwdbwd(c):
        grads = torch.autograd.grad(logits(c).sum(), params,
                                    allow_unused=True)
        return [g for g in grads if g is not None]

    io = dict(xyz=xyz, feats=feats, mask=mask, model=model)
    return [mb.Case(" sort+pyramid (1 block)", pyr, io, 8),
            mb.Case(" full model fwd (1 block)", torch.no_grad()(logits), io,
                    8),
            mb.Case(" full model fwd+bwd wrt params (1 block)", fwdbwd, io,
                    8)]


def step_ms(trainer: Trainer, state, batch) -> float:
    """ms per chained train step: ``STEP_WARMUP`` steps and a host read,
    then ``STEP_REPS`` steps and one host read, on the host clock."""
    for _ in range(STEP_WARMUP):
        state, m = trainer.train_step(state, batch)
    float(m["loss"])
    t0 = time.perf_counter()
    for _ in range(STEP_REPS):
        state, m = trainer.train_step(state, batch)
    float(m["loss"])
    return (time.perf_counter() - t0) / STEP_REPS * 1e3


def bench_model(device="cuda") -> List[mb.Row]:
    """JAX ``bench_model`` (``scripts/model_breakdown.py:119-183``)."""
    trainer, state, batch = model_setup(device)
    rows = mb.run_cases(model_cases(trainer, state, batch), device, mb.REPS)
    label = f" full train step ({batch['xyz'].shape[0]} blocks, chained)"
    ms = step_ms(trainer, state, batch)
    why = "chained steps on the host clock"
    print(f"{label}: {ms:.4f} ms; device not measured ({why})", flush=True)
    return rows + [mb.Row(label, "", ms, None, why, None)]


def main(argv=None) -> List[mb.Row]:
    """Prints the rows; returns them."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--which", default="all",
                   choices=["all", "conv", "convf32", "search", "sort",
                            "model"])
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu (host clock, tests only)")
    args = p.parse_args(argv)
    device = require_device(args.device)
    if device.type == "cuda":
        print(f"[model_breakdown] {card()}; torch {torch.__version__}",
              flush=True)
    mb.measure_baseline(device)
    cases = []
    if args.which in ("all", "conv"):
        cases += conv_cases(True, device)
    if args.which == "convf32":
        cases += conv_cases(False, device)
    if args.which in ("all", "search"):
        cases += search_cases(device)
    if args.which in ("all", "sort"):
        cases += sort_cases(device)
    rows = mb.run_cases(cases, device, mb.REPS)
    if args.which == "model":
        rows += bench_model(device)
    return rows


if __name__ == "__main__":
    main()
