"""Rank bodies of the port's multi-process CPU tests
(``tests/test_torch_parallel.py``, ``tests/test_torch_scene_shard.py``).

Each test module spawns its gloo ranks once (``spawn_once``); every rank
runs all of the module's cases and saves what it saw to
``<tmp>/rank<r>.pt``, and the tests compare those files with the JAX
package and with the port's one-process run.  This module imports torch
and the port only: a spawned rank starts from a fresh interpreter and
need not load JAX.
"""
import datetime
import functools
import os

import numpy as np
import torch

from pointcloudsegmentation_tpu_torch.config import (s3dis_config,
                                                     semantic3d_config)
from pointcloudsegmentation_tpu_torch.data import toy
from pointcloudsegmentation_tpu_torch.models import pointnet as tpointnet
from pointcloudsegmentation_tpu_torch.parallel import scene_shard as ss
from pointcloudsegmentation_tpu_torch.parallel.distributed import (
    global_mesh, initialize, local_batch_to_global, run_ranks)
from pointcloudsegmentation_tpu_torch.parallel.mesh import shard_batch
from pointcloudsegmentation_tpu_torch.train import loop as tloop
from pointcloudsegmentation_tpu_torch.train import model_zoo as tzoo
from pointcloudsegmentation_tpu_torch.train.model_zoo import build_model

# seconds: each rendezvous, collective and join (spawn_once's join: 2x)
TIMEOUT = 120
N = 512                       # points a block
TINY = dict(model="tiny_s3dis", data_num_points=N, data_caps=(256, 64),
            optim_epoch_steps=10, compute_dtype="float32")
TILE = dict(win_tile=64, win_window=64, search_chunk=256)
GLOBAL_BLOCKS = 4             # the mesh steps' global batch
DENSE = dict(model="dense_semantic3d", data_num_points=N,
             data_caps=(256, 64), data_ignore_label=0,
             compute_dtype="float32")


def spawn_once(body, n, tmp):
    """Run ``body(mesh, tmp)`` on ``n`` gloo CPU ranks whose store lives
    in ``tmp``; returns what each rank's body returned, in rank order."""
    run_ranks(_rank, n, (body, n, str(tmp)), timeout=2 * TIMEOUT)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(n)]


def _rank(rank, body, n, tmp):
    torch.set_num_threads(1)
    initialize("file://" + os.path.join(tmp, "store"), n, rank,
               device="cpu", timeout=datetime.timedelta(seconds=TIMEOUT))
    try:
        out = body(global_mesh("cpu"), tmp)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


# -- data parallelism ---------------------------------------------------------

def tiny_batch():
    return next(toy.toy_batches(1, batch_size=GLOBAL_BLOCKS, num_points=N,
                                kind="room", num_classes=13, feat_dim=12,
                                seed=4))


def dense_batch():
    return next(toy.dense_batches(1, 2, num_points=N, dense_factor=4,
                                  seed=7, num_classes=8, feat_dim=13))


def narrow_dense_arch():
    """``tiny_s3dis``'s two stages with an embed before every conv, as the
    Semantic3D arch has (``tests/test_torch_dense.py``'s narrow arch)."""
    m = tpointnet
    return m.Arch(stages=(
        m.StageSpec(rescale=0.3, convs=(
            m.ConvSpec(radius=0.3, k=8, embed=8, fc_dims=(4, 4), out=8),
            m.ConvSpec(radius=0.4, min_radius=0.3, k=6, embed=8,
                       fc_dims=(4, 4), out=8),
        ), pool_fc_dims=(4, 4), pool_out=8),
        m.StageSpec(rescale=0.9, convs=(
            m.ConvSpec(radius=0.9, k=8, embed=8, fc_dims=(4, 4), out=8),
        ), pool_fc_dims=None),
    ), global_dims=(8, 8), global_out=16)


def narrow_dense_pipelines():
    """``model_zoo._PIPELINES`` with the dense model's encoder narrow."""
    p = tzoo._PIPELINES["dense_semantic3d"]
    return dict(tzoo._PIPELINES, dense_semantic3d=p._replace(
        encoder=functools.partial(tzoo._dense_encoder,
                                  arch=narrow_dense_arch())))


def parallel_body(mesh, tmp):
    """Every data-parallel case on one rank."""
    out = {}
    dense = dense_batch()
    out["gathered"] = local_batch_to_global(shard_batch(dense, mesh), mesh)
    out["local_dense"] = shard_batch(dense, mesh)

    trainer = tloop.Trainer(s3dis_config(**TINY), device="cpu", mesh=mesh,
                            **TILE)
    # every rank draws its own weights; init_state replicates rank 0's
    out["init"] = trainer.init_state(
        torch.Generator().manual_seed(mesh.rank)).params
    batch = shard_batch(tiny_batch(), mesh)
    jstate = trainer.init_state(
        state=torch.load(os.path.join(tmp, "jax_state.pt"),
                         weights_only=False))
    out["loss_eval"], out["grad_eval"] = trainer.loss_and_grad(
        jstate, batch, train=False)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    steps = []
    for _ in range(2):
        state, m = trainer.train_step(state, batch)
        steps.append(m)
    out["steps"], out["params"] = steps, state.params

    tzoo._PIPELINES = narrow_dense_pipelines()
    dtrainer = tloop.Trainer(semantic3d_config(**DENSE), device="cpu",
                             mesh=mesh)
    dstate = dtrainer.init_state(torch.Generator().manual_seed(0))
    dstate, out["dense_step"] = dtrainer.train_step(
        dstate, shard_batch(dense, mesh))
    out["dense_params"] = dstate.params
    return out


# -- scene parallelism --------------------------------------------------------

SCENE_N, SHARDS, HALO = 1024, 4, 64
L = SCENE_N // SHARDS
SORT_CELL, EXTENT = 0.2, 64.0
SORT = dict(sort_cell=SORT_CELL, scene_extent=EXTENT)
CELL = 0.5     # cells whose centres are on the 1/1024 m lattice


def lattice_scene(seed, n=SCENE_N, length=24.0):
    """The JAX tests' 24 m corridor with coordinates on a 1/1024 m lattice,
    where the squared distances of the halo selection are exact; 100
    points masked out."""
    rng = np.random.RandomState(seed)
    xyz = np.stack([rng.uniform(0, length, n), rng.uniform(-1.5, 1.5, n),
                    rng.uniform(0, 3.0, n)], 1)
    xyz = (np.round(xyz * 1024) / 1024).astype(np.float32)
    feats = rng.randn(n, 12).astype(np.float32)
    mask = np.ones(n, bool)
    mask[rng.choice(n, 100, replace=False)] = False
    return xyz, feats, mask


def sorted_scene(seed):
    """``lattice_scene`` Morton-sorted as ``scene_apply`` sorts it, with
    each row's sorted index as its one feature column."""
    xyz, _, mask = lattice_scene(seed)
    xs, ms, _ = ss.morton.sort_block(torch.from_numpy(xyz),
                                     torch.from_numpy(mask), SORT_CELL,
                                     EXTENT)
    return xs, torch.arange(SCENE_N, dtype=torch.float32)[:, None], ms


def line_scene():
    """The JAX test's points one metre apart along x, already sorted."""
    x = torch.stack([torch.arange(SCENE_N, dtype=torch.float32),
                     torch.zeros(SCENE_N), torch.zeros(SCENE_N)], 1)
    return (x, torch.arange(SCENE_N, dtype=torch.float32)[:, None],
            torch.ones(SCENE_N, dtype=torch.bool))


def scene_model(ext):
    """``tiny_s3dis`` sized for the extended shard (float32, zero weights
    until the converted JAX ones are loaded)."""
    cfg = s3dis_config(model="tiny_s3dis", data_num_points=ext,
                       data_caps=(192, 48), compute_dtype="float32")
    return build_model(cfg, None, "cpu", search_chunk=128)


def scene_body(mesh, tmp):
    """Every scene-parallel case on one rank."""
    r = mesh.rank
    core = slice(r * L, (r + 1) * L)
    out = {}
    ring = torch.arange(SHARDS * 16, dtype=torch.float32)[:, None]
    out["ring"] = ss.halo_exchange(ring[r * 16:(r + 1) * 16], 4, mesh)
    m = torch.ones(16, dtype=torch.bool)
    out["validity"] = ss.halo_validity(ss.halo_exchange(m, 4, mesh), 4, mesh)

    for name, (x, f, ms) in (("line", line_scene()),
                             ("scene", sorted_scene(1))):
        for cell in (0.0, CELL):
            for halo in (4, HALO):
                out[f"geom_{name}_{cell}_{halo}"] = \
                    ss.geometric_halo_exchange(x[core], f[core], ms[core],
                                               halo, mesh, cell_size=cell)
        out[f"index_{name}"] = ss.exchange_shard(
            x[core], f[core], ms[core], HALO, mesh, "index")

    xyz, feats, mask = (torch.from_numpy(a) for a in lattice_scene(0))
    model = scene_model(L + 2 * HALO)
    model.load_state_dict(torch.load(os.path.join(tmp, "scene_sd.pt")))
    model.eval()

    def apply_fn(x, f, mm):
        return model(x, f, mm, train=False)

    with torch.no_grad():
        for mode, cell in (("index", 0.0), ("geom", CELL)):
            out[f"apply_{mode}"] = ss.scene_apply(
                apply_fn, xyz, feats, mask, mesh, halo=HALO,
                halo_mode=mode, halo_cell=cell, **SORT)

    def boom(*a):
        raise AssertionError("apply_fn must not run")

    for mode, rf, cell in (("index", 0.6, 0.0), ("geom", 1.0, 0.45)):
        try:
            ss.scene_apply(boom, xyz, feats, mask, mesh, halo=1,
                           receptive_field=rf, halo_percentile=100.0,
                           halo_mode=mode, halo_cell=cell, **SORT)
        except ValueError as e:
            out[f"raise_{mode}"] = str(e)
    return out
