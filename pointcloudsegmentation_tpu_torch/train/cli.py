"""Training CLI of the port (mirror of ``pointcloudsegmentation_tpu.train.cli``
on one card): train with per-epoch test metrics and checkpoints, or restore
and evaluate.

Examples:
  python -m pointcloudsegmentation_tpu_torch.train.cli --config s3dis \
      --data-dir data/S3DIS/sampled_train --epochs 100
  python -m pointcloudsegmentation_tpu_torch.train.cli --config s3dis \
      --synthetic --epochs 2 --steps-per-epoch 50   # no dataset required
  python -m pointcloudsegmentation_tpu_torch.train.cli --config semantic3d \
      --data-dir data/Semantic3D/sampled_train   # semantic3d.save_blocks pkls
  python -m pointcloudsegmentation_tpu_torch.train.cli --config modelnet40 \
      --data-dir data/ModelNet40/train   # pkls of (xyz, label) pairs
  python -m pointcloudsegmentation_tpu_torch.train.cli --config semantic3d \
      --model dense_semantic3d --data-dir data/Semantic3D/sampled_train
  python -m pointcloudsegmentation_tpu_torch.train.cli --config semantic3d \
      --model context_semantic3d --data-dir data/Semantic3D/context_train

``--config modelnet40`` trains the ``gpn_modelnet40`` classifier: one
label per cloud, and the metrics count clouds.  ``--model refine_s3dis``
trains the refine cascade (loss refine + base, metrics of the refine
row); ``--use-diffusion STEPS`` smooths a segmentation model's output
probabilities over each point's neighbors (the dense and context models
have no such tail and refuse it).  ``--model dense_semantic3d`` reads
``semantic3d.save_blocks`` pkls (each block's grid-downsampled subset
beside its dense cloud), or trains on synthetic dense batches;
``--model context_semantic3d`` reads pkls of
``semantic3d.prepare_context_scene`` blocks and has no synthetic data.
It runs on the card (``--device cuda``) unless ``--device cpu`` is
given, and raises where there is no card.

By default it trains data-parallel over a mesh of ``--devices`` ranks, as
the JAX CLI trains over every device: one rank per card under NCCL
(default: every visible card), or ``--devices N`` ranks on the CPU under
gloo with ``--device cpu`` (default 1).  N > 1 ranks are spawned processes
that meet through a ``file://`` store in a temporary directory; a mesh of
one rank runs in this process.  The batch size rounds down to a multiple
of N (at least N), every rank builds the same global batches and steps on
its slice of them, and rank 0 alone writes the log, the metrics and the
checkpoints (every rank restores).  ``--no-mesh`` trains in this process
with no process group.
"""
from __future__ import annotations

import argparse
import datetime
import glob
import json
import logging
import os
import tempfile
from typing import Optional

import numpy as np
import torch

from .. import config as config_lib
from ..config import CONFIGS, require_device
from ..data import toy
from ..data.provider import Provider
from ..parallel.distributed import (DEFAULT_TIMEOUT, global_mesh,
                                    initialize, run_ranks)
from ..parallel.mesh import Mesh, shard_batch
from ..utils.logging import get_logger
from .checkpoint import CheckpointManager
from .loop import Trainer, TrainState
from .model_zoo import read_fn_for


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", choices=sorted(CONFIGS), default="s3dis")
    p.add_argument("--model", type=str, default=None,
                   help="override model registry key (e.g. tiny_s3dis)")
    p.add_argument("--data-dir", type=str, default=None)
    p.add_argument("--test-data-dir", type=str, default=None)
    p.add_argument("--synthetic", action="store_true",
                   help="train on synthetic blocks (smoke/bench)")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None,
                   help="blocks per step; default cfg.batch_per_device")
    p.add_argument("--num-points", type=int, default=None)
    p.add_argument("--lr-init", type=float, default=None)
    p.add_argument("--checkpoint-dir", type=str, default=None)
    p.add_argument("--restore", action="store_true")
    p.add_argument("--restore-epoch", type=int, default=None)
    p.add_argument("--restore-best", action="store_true",
                   help="restore the highest-mIoU checkpoint instead of "
                        "the latest epoch")
    p.add_argument("--log-file", type=str, default=None)
    p.add_argument("--metrics-file", type=str, default=None,
                   help="per-epoch metrics JSONL (default: alongside "
                        "--log-file / --checkpoint-dir)")
    p.add_argument("--eval", action="store_true",
                   help="evaluate only (restore + test epoch)")
    p.add_argument("--use-diffusion", type=int, default=0, metavar="STEPS",
                   help="probs-diffusion smoothing steps "
                        "(train_graph_pool.py --use_diffusion)")
    p.add_argument("--ablate-feats", choices=["none", "zero", "drop-rgb",
                                              "drop-covars"], default="none",
                   help="feature-ablation retraining (the reference's "
                        "train_feats_compare*.py experiments)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--no-mesh", action="store_true",
                   help="one process, no process group")
    p.add_argument("--devices", type=int, default=None,
                   help="ranks of the mesh: one per card under NCCL "
                        "(default every visible card), or with --device "
                        "cpu ranks on the CPU under gloo (default 1)")
    return p.parse_args(argv)


def build_cfg(args) -> config_lib.TrainConfig:
    over = {}
    if args.model:
        over["model"] = args.model
    if args.epochs:
        over["num_epochs"] = args.epochs
    if args.num_points:
        over["data_num_points"] = args.num_points
    if args.lr_init:
        over["optim_lr_init"] = args.lr_init
    if args.steps_per_epoch:
        over["optim_epoch_steps"] = args.steps_per_epoch
    if args.checkpoint_dir:
        over["checkpoint_dir"] = args.checkpoint_dir
    if args.use_diffusion:
        over["diffusion_steps"] = args.use_diffusion
    return CONFIGS[args.config](**over)


def _ablate(batch, mode):
    if mode == "none":
        return batch
    feats = batch["feats"]
    if mode == "zero":
        feats = np.zeros_like(feats)
    elif mode == "drop-rgb":
        feats = np.concatenate([np.zeros_like(feats[..., :3]),
                                feats[..., 3:]], -1)
    elif mode == "drop-covars":
        feats = feats.copy()
        feats[..., 3:] = 0
    out = dict(batch)
    out["feats"] = feats
    return out


def make_batches(cfg, args, split: str, batch_size: int):
    """A callable giving epoch ``e``'s batches of ``split``: synthetic room
    blocks, or synthetic dense batches for ``dense_semantic3d`` (train
    seed 0, test seed 1, the same every epoch), or the
    Provider over the split's pkls.  The train Provider is seeded with the
    epoch number, so every epoch has its own file order, block shuffle and
    subsample (the JAX CLI seeds every epoch 0); the test Provider keeps
    seed 0, so every test pass reads the same batches."""
    d = cfg.data
    if args.synthetic or not args.data_dir:
        steps = args.steps_per_epoch or 50
        if cfg.model == "context_semantic3d":
            raise ValueError(
                "context_semantic3d has no synthetic batches: give "
                "--data-dir pkls of semantic3d.prepare_context_scene blocks "
                "(each block's 50 m context cloud and context indices)")
        if cfg.model == "dense_semantic3d":
            return lambda epoch: (_ablate(b, args.ablate_feats)
                                  for b in toy.dense_batches(
                                      steps, batch_size,
                                      num_points=d.num_points,
                                      num_classes=d.num_classes,
                                      feat_dim=max(d.feat_dim, 1),
                                      seed=0 if split == "train" else 1))
        return lambda epoch: (_ablate(b, args.ablate_feats)
                              for b in toy.toy_batches(
                                  steps, batch_size, num_points=d.num_points,
                                  kind="room",
                                  num_classes=d.num_classes,
                                  feat_dim=max(d.feat_dim, 1),
                                  seed=0 if split == "train" else 1))
    data_dir = args.data_dir if split == "train" else (
        args.test_data_dir or args.data_dir)
    files = sorted(glob.glob(os.path.join(data_dir, "*.pkl")))
    if not files:
        raise FileNotFoundError(f"no .pkl files in {data_dir}")
    read_fn = read_fn_for(cfg, args.config)
    return lambda epoch: (_ablate(b, args.ablate_feats)
                          for b in Provider(
                              files, split, batch_size, read_fn,
                              d.num_points,
                              seed=epoch if split == "train" else 0))


def _sharded(batches_fn, mesh: Optional[Mesh]):
    """``batches_fn`` with each global batch cut to this rank's blocks."""
    if mesh is None:
        return batches_fn
    return lambda epoch: (shard_batch(b, mesh) for b in batches_fn(epoch))


def _metrics_writer(args, cfg):
    """Append-mode JSONL sink for per-epoch eval metrics: one JSON object
    per epoch, in place of grepping free-text logs
    (analysis_feats_compare.py:7-39)."""
    path = args.metrics_file
    if path is None and args.log_file:
        path = os.path.splitext(args.log_file)[0] + ".metrics.jsonl"
    if path is None and cfg.checkpoint_dir:
        path = os.path.join(cfg.checkpoint_dir, "metrics.jsonl")
    if path is None:
        return lambda rec: None
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def write(rec):
        def clean(v):
            if isinstance(v, np.ndarray):
                return [float(x) for x in v]
            return float(v) if isinstance(v, (np.floating, np.integer)) \
                else v
        with open(path, "a") as f:
            f.write(json.dumps({k: clean(v) for k, v in rec.items()}) + "\n")

    return write


def main(argv=None, timeout: Optional[float] = None):
    """Train or evaluate as the arguments say; returns the final
    ``TrainState`` (the ``--eval`` metrics with ``--eval``): rank 0's,
    with its tensors on the CPU, when the mesh spans several ranks.
    ``timeout`` (seconds) bounds the mesh's rendezvous and every
    collective, and with several ranks their whole run; ``None`` keeps the
    group's default (``DEFAULT_TIMEOUT`` a collective) and no bound on the
    run, which may take days."""
    args = parse_args(argv)
    device = require_device(args.device)
    if args.no_mesh:
        return _run(args, device, None)
    n = args.devices or (torch.cuda.device_count()
                         if device.type == "cuda" else 1)
    if device.type == "cuda" and n > torch.cuda.device_count():
        raise ValueError(f"--devices {n}: NCCL needs one card per rank and "
                         f"this host shows {torch.cuda.device_count()}")
    if torch.distributed.is_initialized():
        raise RuntimeError("the train CLI starts its own process group; "
                           "this process already belongs to one")
    with tempfile.TemporaryDirectory() as tmp:
        store = "file://" + os.path.join(tmp, "store")
        if n == 1:
            return _run_rank(0, 1, store, args, None, timeout)
        out = os.path.join(tmp, "result.pt")
        run_ranks(_run_rank, n, (n, store, args, out, timeout), timeout)
        return torch.load(out, weights_only=False)


def _run_rank(rank: int, n: int, store: str, args, out: Optional[str],
              timeout: Optional[float]):
    """Rank ``rank`` of ``n``: join the group, train or evaluate, and (rank
    0, when ``out`` is given) save the result there for the parent."""
    if n > 1:   # the ranks share the host's cores
        torch.set_num_threads(max(torch.get_num_threads() // n, 1))
    initialize(store, n, rank, device=args.device,
               timeout=DEFAULT_TIMEOUT if timeout is None
               else datetime.timedelta(seconds=timeout))
    try:
        mesh = global_mesh(args.device)
        res = _run(args, mesh.device, mesh)
        if out is not None and rank == 0:
            if isinstance(res, TrainState):
                res = res.to("cpu")
            torch.save(res, out)
        return res
    finally:
        torch.distributed.destroy_process_group()


def _run(args, device: torch.device, mesh: Optional[Mesh]):
    cfg = build_cfg(args)
    lead = mesh is None or mesh.rank == 0
    log = get_logger("pcs_torch.cli", args.log_file if lead else None)
    if not lead:
        log.setLevel(logging.WARNING)
    write_metrics = _metrics_writer(args, cfg) if lead \
        else (lambda rec: None)

    n_dev = 1 if mesh is None else mesh.size
    batch_size = args.batch_size or max(n_dev * cfg.batch_per_device, 1)
    batch_size = (batch_size // n_dev) * n_dev or n_dev
    log.info("config=%s model=%s device=%s ranks=%d batch=%d points=%d",
             args.config, cfg.model, device, n_dev, batch_size,
             cfg.data.num_points)

    trainer = Trainer(cfg, device=device, mesh=mesh)
    train_batches = _sharded(make_batches(cfg, args, "train", batch_size),
                             mesh)
    test_batches = _sharded(make_batches(cfg, args, "test", batch_size),
                            mesh)

    state = trainer.init_state(torch.Generator().manual_seed(cfg.seed))
    ckpt: Optional[CheckpointManager] = None
    start_epoch = 0
    restoring = args.restore or args.restore_best
    if cfg.checkpoint_dir and (lead or restoring):
        ckpt = CheckpointManager(cfg.checkpoint_dir, cfg.keep_checkpoints)
        if args.restore_best:
            state = ckpt.restore_best(state)
            start_epoch = (ckpt.latest_epoch() or 0) + 1
            log.info("restored best epoch %d", ckpt.best_epoch())
        elif args.restore:
            state = ckpt.restore(state, args.restore_epoch)
            start_epoch = (ckpt.latest_epoch() or 0) + 1
            log.info("restored epoch %d", start_epoch - 1)

    try:
        if args.eval:
            state, res = trainer.run_epoch(state, test_batches(0),
                                           train=False)
            log.info("eval mIoU %.4f oIoU %.4f oAcc %.4f loss %.4f",
                     res["miou"], res["oiou"], res["oacc"],
                     res.get("loss", 0))
            for i, iou in enumerate(res["iou"]):
                log.info("  class %d iou %.4f acc %.4f", i, iou,
                         res["acc"][i])
            write_metrics({"epoch": -1, "split": "eval",
                           "miou": res["miou"], "oiou": res["oiou"],
                           "oacc": res["oacc"], "loss": res.get("loss", 0),
                           "iou": res["iou"], "acc": res["acc"]})
            return res

        for epoch in range(start_epoch, cfg.num_epochs):
            # the LR at the epoch's first step: the state after the epoch
            # would read the next step's schedule value
            epoch_lr = trainer.lr_at(state.step)
            state, tr = trainer.run_epoch(state, train_batches(epoch),
                                          train=True)
            state, te = trainer.run_epoch(state, test_batches(epoch),
                                          train=False)
            log.info("epoch %d train-loss %.4f | test mIoU %.4f oIoU %.4f "
                     "oAcc %.4f | %.0f points/s",
                     epoch, tr.get("loss", 0), te["miou"], te["oiou"],
                     te["oacc"], tr["points_per_sec"])
            write_metrics({"epoch": epoch, "train_loss": tr.get("loss", 0),
                           "lr": epoch_lr,
                           "miou": te["miou"], "oiou": te["oiou"],
                           "oacc": te["oacc"], "iou": te["iou"],
                           "acc": te["acc"],
                           "points_per_sec": tr["points_per_sec"]})
            if ckpt is not None and lead:
                # written in the background from a host snapshot
                ckpt.save(epoch, state, metrics={"miou": float(te["miou"])})
        return state
    finally:
        if ckpt is not None:
            ckpt.close()


if __name__ == "__main__":
    main()
