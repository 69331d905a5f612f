"""Scene-shard halo fidelity study (the port's counterpart of
``scripts/halo_study.py``).

Shards a synthetic corridor scene over ``--shards`` ranks with
``parallel.scene_shard.scene_apply`` at several halo sizes, in both halo
modes, and measures each arm's logits against the same sharded run with
the full neighbour shards as its halo (``index`` mode, halo = L), which
isolates halo truncation from the shard-local frame; then it sizes the
data-driven halo rules (``required_halo`` at 100 and 99.9 percent,
``geometric_required_halo``) at ``tiny_s3dis``'s receptive field and runs
their halos as arms too.  Every arm uses the exact global neighbour search
(``build_model(windowed=False)``): the extended shard's length would
otherwise switch the windowed search on and off from halo to halo.

    python -m pointcloudsegmentation_tpu_torch.halo_study --device cpu
    python -m pointcloudsegmentation_tpu_torch.halo_study --shards 4 \\
        --backend gloo      # 4 ranks sharing one card

Writes ``results/halo_study_torch.json``.  On the card the ranks default to
NCCL, one card each; ``--backend gloo`` lets them share a card.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import tempfile

import numpy as np
import torch

from .config import require_device, s3dis_config
from .ops import morton
from .parallel.distributed import global_mesh, initialize, run_ranks
from .parallel.scene_shard import (geometric_required_halo,
                                   model_receptive_field, required_halo,
                                   scene_apply)
from .train.model_zoo import build_model
from .utils.logging import get_logger

RUN_TIMEOUT = 1800.0   # seconds the ranks may take, all arms included


def corridor_scene(rng: np.random.RandomState, n: int, length: float):
    """``n`` uniform points in a ``length`` x 3 x 3 m corridor with 12
    random features, all valid (numpy; the JAX study's scene)."""
    xyz = np.stack([rng.uniform(0, length, n),
                    rng.uniform(-1.5, 1.5, n),
                    rng.uniform(0, 3.0, n)], 1).astype(np.float32)
    feats = rng.randn(n, 12).astype(np.float32)
    mask = np.ones(n, bool)
    return xyz, feats, mask


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n", type=int, default=8192)
    p.add_argument("--length", type=float, default=48.0)
    p.add_argument("--shards", type=int, default=8)
    p.add_argument("--halos", type=int, nargs="*",
                   default=[16, 32, 64, 128, 256])
    p.add_argument("--sort-cell", type=float, default=0.2)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                   help="default: nccl on the card, gloo on the CPU")
    p.add_argument("--out", default="results/halo_study_torch.json")
    return p.parse_args(argv)


def _rank(rank, args, store):
    torch.set_num_threads(max(torch.get_num_threads() // args.shards, 1))
    initialize(store, args.shards, rank, backend=args.backend,
               device=args.device)
    try:
        _study(global_mesh(args.device), args)
    finally:
        torch.distributed.destroy_process_group()


def _study(mesh, args):
    log = get_logger("pcs_torch.halo_study")
    if mesh.rank:
        log.setLevel(logging.WARNING)    # rank 0 reports
    d = mesh.size
    L = args.n // d
    xyz, feats, mask = corridor_scene(np.random.RandomState(0), args.n,
                                      args.length)
    h_max = L        # the reference: the full neighbour shards
    if max(args.halos) >= h_max:
        raise ValueError(f"halos must stay below the shard length {L}")
    # one model for every halo (the convs take any point count), its caps
    # at one voxel a point for the largest extended shard: the corridor is
    # sparse, and a saturated cap drops points in Morton order
    ext = L + 2 * h_max
    cfg = s3dis_config(model="tiny_s3dis", data_num_points=ext,
                       data_caps=(ext, ext // 2),
                       data_block_size=float(args.length),
                       compute_dtype="float32")
    model = build_model(cfg, torch.Generator().manual_seed(0), mesh.device,
                        windowed=False, search_chunk=256).eval()
    dev = mesh.device
    xyz_t, feats_t, mask_t = (torch.from_numpy(a).to(dev)
                              for a in (xyz, feats, mask))

    def run(h, mode):
        with torch.no_grad():
            return scene_apply(
                lambda x, f, m: model(x, f, m, train=False), xyz_t, feats_t,
                mask_t, mesh, halo=h, sort_cell=args.sort_cell,
                scene_extent=args.length, halo_mode=mode,
                halo_cell=cfg.data.voxel_sizes[-1]).cpu().numpy()

    ref = run(h_max, "index")
    rf = model_receptive_field(model.encoder.arch)
    xyz_s, mask_s, _ = morton.sort_block(xyz_t, mask_t, args.sort_cell,
                                         args.length)
    xs, ms = xyz_s.cpu().numpy(), mask_s.cpu().numpy()
    need_exact = required_halo(xs, ms, d, rf, 100.0)
    need_p999 = required_halo(xs, ms, d, rf, 99.9)
    geom_need, unreachable = geometric_required_halo(
        xs, ms, d, rf, cell_size=cfg.data.voxel_sizes[-1])
    log.info("receptive field %.2f m -> required halo: index exact=%d "
             "p99.9=%d | geom=%d (unreachable pairs=%d) (L=%d)", rf,
             need_exact, need_p999, geom_need, unreachable, L)

    rows = []
    for h in sorted(set(args.halos + [min(need_p999, L - 1),
                                      min(geom_need, L - 1)])):
        row = {"halo": int(h)}
        for mode in ("geom", "index"):
            out = run(h, mode)
            dm = np.abs(out - ref)[mask]
            agree = float((out.argmax(-1) == ref.argmax(-1))[mask].mean())
            row[f"{mode}_argmax_agreement"] = round(agree, 5)
            row[f"{mode}_logit_mae"] = round(float(dm.mean()), 6)
            row[f"{mode}_logit_max_err"] = round(float(dm.max()), 4)
            log.info("halo %4d %5s: agree %.4f mae %.5f max %.3f", h, mode,
                     agree, dm.mean(), dm.max())
        rows.append(row)

    if mesh.rank == 0:
        res = {"n": args.n, "length": args.length, "shards": d,
               "device": str(dev) if dev.type == "cpu"
               else torch.cuda.get_device_name(dev),
               "backend": mesh.backend, "receptive_field_m": rf,
               "required_halo_exact": int(need_exact),
               "required_halo_p999": int(need_p999),
               "geom_required_halo": int(geom_need),
               "unreachable_pairs": int(unreachable), "rows": rows}
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=2)
        log.info("wrote %s", args.out)


def main(argv=None):
    args = parse_args(argv)
    device = require_device(args.device)
    if args.backend is None:
        args.backend = "nccl" if device.type == "cuda" else "gloo"
    if args.backend == "nccl" and args.shards > torch.cuda.device_count():
        raise ValueError(f"{args.shards} NCCL ranks need as many cards; "
                         "give --backend gloo to share one")
    with tempfile.TemporaryDirectory() as tmp:
        run_ranks(_rank, args.shards,
                  (args, "file://" + os.path.join(tmp, "store")),
                  RUN_TIMEOUT)


if __name__ == "__main__":
    main()
