"""Dry-run entry points of the port (counterpart of the repository's
``__graft_entry__.py``).

    entry(device)            -> (fn, example_args): the flagship's forward
                                on a 512-point block
    dryrun_multichip(n, ...) -> one data-parallel training step of
                                ``tiny_s3dis`` over n ranks, held against
                                the one-process step, then one scene
                                sharded over the same ranks, held against
                                the sequential run

``dryrun_multichip`` runs n gloo ranks with ``device="cpu"``, or one rank
per card under NCCL on the card (it raises where the host shows fewer than
n cards).

    python -m pointcloudsegmentation_tpu_torch.dryrun --devices 2 --device cpu
"""
from __future__ import annotations

import argparse
import datetime
import os
import tempfile

import numpy as np
import torch

from .config import require_device, s3dis_config
from .data import toy
from .parallel.distributed import global_mesh, initialize, run_ranks
from .parallel.mesh import shard_batch
from .parallel.scene_shard import scene_apply, sequential_scene_apply
from .train.loop import Trainer
from .train.model_zoo import build_model

BLOCKS_PER_RANK = 2          # the accumulation inside each rank's step
SCENE_L, SCENE_HALO = 256, 64  # shard length and halo of the scene run
LOSS_RTOL = 1e-6             # mesh step vs one-process step: loss
PARAM_TOL = 1e-6             # params, of the largest |param|
LOGIT_TOL = 1e-5             # scene logits, of the largest |logit|


def _tiny_cfg(**over):
    return s3dis_config(data_num_points=512, data_caps=(256, 64),
                        optim_epoch_steps=10, **over)


# the mesh step's model: float32, so the comparisons see only the order of
# the gradient sum
_MESH_CFG = dict(model="tiny_s3dis", compute_dtype="float32")


def _example_batch(batch_size, num_points=512):
    return next(toy.toy_batches(1, batch_size=batch_size,
                                num_points=num_points, kind="room",
                                num_classes=13, feat_dim=12))


def entry(device="cuda"):
    """The flagship S3DIS model's forward on one 512-point block: (fn,
    (xyz, feats, mask)) with ``fn(xyz, feats, mask) -> [N, 13]`` logits."""
    device = require_device(device)
    model = build_model(_tiny_cfg(), torch.Generator().manual_seed(0),
                        device).eval()
    batch = _example_batch(1)
    args = tuple(torch.from_numpy(batch[k][0]).to(device)
                 for k in ("xyz", "feats", "mask"))

    def fn(xyz, feats, mask):
        return model(xyz, feats, mask, train=False)

    return fn, args


def _scene(n):
    rs = np.random.RandomState(1)
    scene_n = SCENE_L * n
    xyz = np.stack([rs.uniform(0, 3.0 * n, scene_n),
                    rs.uniform(-1.5, 1.5, scene_n),
                    rs.uniform(0, 3.0, scene_n)], 1).astype(np.float32)
    return (torch.from_numpy(xyz), torch.from_numpy(
        rs.randn(scene_n, 12).astype(np.float32)),
        torch.ones(scene_n, dtype=torch.bool))


def _scene_kw(n):
    return dict(halo=SCENE_HALO, sort_cell=0.2,
                scene_extent=float(max(64, 4 * n)))


def _rank(rank, n, store, device, out_dir, timeout):
    torch.set_num_threads(1)
    initialize(store, n, rank, device=device,
               timeout=datetime.timedelta(seconds=timeout))
    try:
        mesh = global_mesh(device)
        trainer = Trainer(_tiny_cfg(**_MESH_CFG), device=mesh.device,
                          mesh=mesh, search_chunk=256)
        state = trainer.init_state(torch.Generator().manual_seed(0))
        batch = shard_batch(_example_batch(BLOCKS_PER_RANK * n), mesh)
        state, m = trainer.train_step(state, batch)
        model = trainer.bind(state).eval()
        xyz, feats, mask = (t.to(mesh.device) for t in _scene(n))
        with torch.no_grad():
            logits = scene_apply(
                lambda x, f, mm: model(x, f, mm, train=False), xyz, feats,
                mask, mesh, **_scene_kw(n))
        torch.save({"loss": m["loss"].cpu(), "cm": m["cm"].cpu(),
                    "params": state.params.cpu(), "logits": logits.cpu()},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def dryrun_multichip(n_devices: int, device="cuda",
                     timeout: float = 600.0) -> None:
    """One full mesh training step of ``tiny_s3dis`` (``BLOCKS_PER_RANK``
    blocks of 512 points on each of ``n_devices`` ranks, one ``all_reduce``)
    and one corridor scene of ``SCENE_L`` points a rank through
    ``scene_apply``; raises unless every rank's parameters are equal, the
    step agrees with the one-process step on all the blocks and the scene
    with ``sequential_scene_apply``.  ``timeout`` (seconds) bounds the
    rendezvous, every collective and the ranks' whole run."""
    device = require_device(device)
    if device.type == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(f"{n_devices} NCCL ranks need as many cards; this "
                         f"host shows {torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory() as tmp:
        run_ranks(_rank, n_devices, (n_devices, "file://" + os.path.join(
            tmp, "store"), str(device), tmp, timeout), timeout)
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                 for r in range(n_devices)]

    for r in ranks[1:]:
        if not torch.equal(r["params"], ranks[0]["params"]):
            raise AssertionError("the ranks' parameters differ after the "
                                 "step")
    trainer = Trainer(_tiny_cfg(**_MESH_CFG), device=device,
                      search_chunk=256)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    state, m = trainer.train_step(
        state, _example_batch(BLOCKS_PER_RANK * n_devices))
    got = ranks[0]
    loss = float(got["loss"])
    if not np.isfinite(loss) or abs(loss - float(m["loss"])) > \
            LOSS_RTOL * abs(float(m["loss"])):
        raise AssertionError(f"mesh loss {loss}, one-process "
                             f"{float(m['loss'])}")
    if not torch.equal(got["cm"], m["cm"].cpu()):
        raise AssertionError("mesh confusion matrix differs")
    scale = state.params.abs().max().item()
    err = (got["params"] - state.params.cpu()).abs().max().item()
    if err > PARAM_TOL * scale:
        raise AssertionError(f"mesh params differ by {err} (scale {scale})")
    model = trainer.bind(state).eval()
    xyz, feats, mask = (t.to(device) for t in _scene(n_devices))
    with torch.no_grad():
        ref = sequential_scene_apply(
            lambda x, f, mm: model(x, f, mm, train=False), xyz, feats, mask,
            n_devices, **_scene_kw(n_devices)).cpu()
    if not torch.isfinite(got["logits"]).all() or \
            (got["logits"] - ref).abs().max() > \
            LOGIT_TOL * ref.abs().max().clamp(min=1.0):
        raise AssertionError("scene_apply differs from the sequential run")
    print(f"dryrun_multichip({n_devices}): loss={loss:.4f} params equal "
          "across ranks, step and scene_shard match the one-process run")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--devices", type=int, default=2)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    fn, example = entry(args.device)
    print("entry forward:", tuple(fn(*example).shape))
    dryrun_multichip(args.devices, args.device)


if __name__ == "__main__":
    main()
