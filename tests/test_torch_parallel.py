"""The port's data parallelism (``parallel/mesh.py``, ``parallel/
distributed.py``, ``Trainer(mesh=...)``, the train CLI's mesh and
``dryrun.py``) on 2 gloo CPU ranks: the batch split and gathered back
(extra fields included), rank 0's state on every rank, the mesh's
``train=False`` gradient of ``tiny_s3dis`` against the JAX gradient of
the same global batch, the mesh step with dropout against the port's
one-process step (every block draws the stream of its global index), a
dense-pipeline key through one mesh step, the CLI's ``--devices 2``
against ``--no-mesh``, and ``dryrun_multichip(2)``.  The ranks are spawned
once for the module (``torch_ranks.parallel_body``)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch_ranks as R
from jax.flatten_util import ravel_pytree
from test_torch_model import random_params

from pointcloudsegmentation_tpu.train.config import s3dis_config as js3dis
from pointcloudsegmentation_tpu.train.loop import Trainer as JTrainer
from pointcloudsegmentation_tpu.train.loop import TrainState as JState
from pointcloudsegmentation_tpu.train.loop import \
    seg_loss_terms as jseg_terms
from pointcloudsegmentation_tpu_torch import dryrun
from pointcloudsegmentation_tpu_torch.config import (s3dis_config,
                                                     semantic3d_config)
from pointcloudsegmentation_tpu_torch.convert import \
    flax_train_state_to_torch
from pointcloudsegmentation_tpu_torch.parallel.distributed import (
    global_mesh, initialize)
from pointcloudsegmentation_tpu_torch.parallel.mesh import (Mesh, make_mesh,
                                                            shard_batch)
from pointcloudsegmentation_tpu_torch.train import cli
from pointcloudsegmentation_tpu_torch.train import loop as tloop
from pointcloudsegmentation_tpu_torch.train import model_zoo as tzoo

torch.set_num_threads(1)

RANKS = 2


@pytest.fixture(scope="module")
def jax_grad():
    """``tiny_s3dis``'s JAX ``train=False`` loss and flat gradient over the
    4-block global batch (Σ∇S_b / ΣW_b, one program per block), with its
    seeded random weights as a JAX train state."""
    batch = R.tiny_batch()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PCS_WIN_WINDOW", "64")
        trainer = JTrainer(js3dis(**R.TINY), search_chunk=256)
        assert trainer.model.encoder.win_tile == 64
        params = random_params(trainer.model, batch["xyz"][0],
                               batch["feats"][0], batch["mask"][0], seed=5)
        cw = jnp.asarray(trainer.class_weights)

        def block_terms(p, xyz, feats, mask, labels):
            logits = trainer.model.apply(p, xyz, feats, mask, False)
            s, w, _, _ = jseg_terms(logits, labels, mask, cw, None)
            return s, w

        fn = jax.jit(jax.value_and_grad(block_terms, has_aux=True))
        s_sum = w_sum = 0.0
        g_sum = 0.0
        for b in range(R.GLOBAL_BLOCKS):
            (s, w), g = fn(params, *(batch[k][b] for k in
                                     ("xyz", "feats", "mask", "labels")))
            s_sum, w_sum = s_sum + float(s), w_sum + float(w)
            g_sum = g_sum + np.array(ravel_pytree(g)[0], np.float64)
        vec, _ = ravel_pytree(params)
        state = JState(step=np.int32(0), params=params,
                       opt_state=trainer.tx.init(vec))
        state = jax.tree_util.tree_map(np.array, state)
    return state, s_sum / w_sum, g_sum / w_sum


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_grad):
    tmp = tmp_path_factory.mktemp("parallel_ranks")
    trainer = tloop.Trainer(s3dis_config(**R.TINY), device="cpu", **R.TILE)
    torch.save(flax_train_state_to_torch(jax_grad[0], trainer.model),
               tmp / "jax_state.pt")
    return R.spawn_once(R.parallel_body, RANKS, tmp)


def test_initialize_does_nothing_for_one_process():
    initialize()
    initialize(world_size=1, rank=0)
    assert not dist.is_initialized()
    mesh = global_mesh("cpu")
    assert (mesh.size, mesh.rank, mesh.group, mesh.backend) == \
        (1, 0, None, None)
    with pytest.raises(ValueError, match="mesh of 2 ranks"):
        make_mesh(2, "cpu")
    with pytest.raises(ValueError, match="init_method"):
        initialize(world_size=2, rank=0)


def test_shard_batch_slices_every_field():
    batch = R.dense_batch()
    batch = {k: np.concatenate([v, v[::-1]]) for k, v in batch.items()}
    mesh = Mesh(None, 1, 2, "gloo", torch.device("cpu"))
    got = shard_batch(batch, mesh)
    assert {"dense_xyz", "dense_feats", "dense_mask"} <= got.keys()
    for k, v in batch.items():
        np.testing.assert_array_equal(got[k], v[2:])
    with pytest.raises(ValueError, match="does not split"):
        shard_batch({k: v[:3] for k, v in batch.items()}, mesh)


def test_gathered_shards_give_the_global_batch(ranks):
    want = R.dense_batch()
    for r, res in enumerate(ranks):
        assert res["gathered"].keys() == want.keys()
        for k, v in want.items():
            assert res["gathered"][k].dtype == v.dtype, k
            np.testing.assert_array_equal(res["gathered"][k], v)
            np.testing.assert_array_equal(res["local_dense"][k], v[r:r + 1])


def test_replicate_gives_rank0_state(ranks):
    trainer = tloop.Trainer(s3dis_config(**R.TINY), device="cpu", **R.TILE)
    want = trainer.init_state(torch.Generator().manual_seed(0)).params
    for res in ranks:
        assert torch.equal(res["init"], want)


def test_mesh_grads_match_jax(ranks, jax_grad):
    """The mesh's ``loss_and_grad(train=False)`` on 2 blocks a rank is the
    JAX loss and flat gradient of the 4-block batch, to 1e-4 after dividing
    by max(1, the largest |JAX value|), on every rank."""
    _, loss, grad = jax_grad
    scale = max(1.0, np.abs(grad).max())
    assert np.abs(grad).max() > 1e-2
    for res in ranks:
        np.testing.assert_allclose(float(res["loss_eval"]), loss, rtol=1e-4)
        np.testing.assert_allclose(res["grad_eval"].numpy() / scale,
                                   grad / scale, rtol=0, atol=1e-4)


def test_mesh_step_matches_one_process_step(ranks):
    """Two mesh steps with dropout against two one-process steps on the
    whole batch: loss to rel 1e-6, metrics equal, params within 1e-6 of
    their largest magnitude, and bitwise equal across the ranks."""
    trainer = tloop.Trainer(s3dis_config(**R.TINY), device="cpu", **R.TILE)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    batch = R.tiny_batch()
    for got in ranks[0]["steps"]:
        state, m = trainer.train_step(state, batch)
        np.testing.assert_allclose(float(got["loss"]), float(m["loss"]),
                                   rtol=1e-6)
        for key in ("cm", "correct", "count", "skipped"):
            assert torch.equal(got[key], m[key]), key
    scale = state.params.abs().max().item()
    assert (ranks[0]["params"] - state.params).abs().max().item() <= \
        1e-6 * scale
    assert torch.equal(ranks[0]["params"], ranks[1]["params"])


def test_dense_key_takes_a_mesh_step(ranks, monkeypatch):
    """``dense_semantic3d`` (narrow encoder) with its ``dense_*`` fields
    split over the ranks: the one-process step's loss and metrics."""
    monkeypatch.setattr(tzoo, "_PIPELINES", R.narrow_dense_pipelines())
    trainer = tloop.Trainer(semantic3d_config(**R.DENSE), device="cpu")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    state, m = trainer.train_step(state, R.dense_batch())
    got = ranks[0]["dense_step"]
    assert np.isfinite(float(got["loss"]))
    np.testing.assert_allclose(float(got["loss"]), float(m["loss"]),
                               rtol=1e-6)
    assert torch.equal(got["cm"], m["cm"])
    assert torch.equal(ranks[0]["dense_params"], ranks[1]["dense_params"])
    scale = state.params.abs().max().item()
    assert (ranks[0]["dense_params"] - state.params).abs().max().item() \
        <= 1e-6 * scale


def test_cli_mesh_matches_no_mesh(tmp_path):
    """``--device cpu --devices 2`` (2 spawned gloo ranks, their group and
    run bounded by ``R.TIMEOUT``) writes the ``--no-mesh`` run's metrics
    records (floats to 1e-6; the throughput aside), and only rank 0
    writes: one record an epoch, one log, one checkpoint an epoch."""
    base = ["--model", "tiny_s3dis", "--num-points", "512", "--synthetic",
            "--epochs", "2", "--steps-per-epoch", "1", "--batch-size", "2",
            "--device", "cpu"]
    runs = {}
    for name, extra in (("mesh", ["--devices", "2"]), ("alone",
                                                        ["--no-mesh"])):
        d = tmp_path / name
        d.mkdir()
        state = cli.main(base + extra + ["--log-file", str(d / "log.txt"),
                                         "--checkpoint-dir", str(d / "ck")],
                         timeout=R.TIMEOUT)
        assert state.step == 2
        with open(d / "log.metrics.jsonl") as f:
            runs[name] = [json.loads(line) for line in f]
        log = (d / "log.txt").read_text()
        assert log.count("config=s3dis") == 1
        assert sorted(p.name for p in (d / "ck").iterdir()) == \
            ["best", "epoch_000000.pt", "epoch_000001.pt"]
    assert "ranks=2" in (tmp_path / "mesh" / "log.txt").read_text()
    assert len(runs["mesh"]) == len(runs["alone"]) == 2
    for a, b in zip(runs["mesh"], runs["alone"]):
        assert a.keys() == b.keys()
        for k in a:
            if k != "points_per_sec":
                np.testing.assert_allclose(a[k], b[k], rtol=1e-6, err_msg=k)


def test_dryrun_entry_and_multichip():
    fn, args = dryrun.entry("cpu")
    assert tuple(fn(*args).shape) == (512, 13)
    dryrun.dryrun_multichip(RANKS, "cpu", timeout=R.TIMEOUT)


def test_trainer_refuses_a_mesh_on_another_device():
    mesh = Mesh(None, 0, 1, None, torch.device("meta"))
    with pytest.raises(ValueError, match="rank runs on"):
        tloop.Trainer(s3dis_config(**R.TINY), device="cpu", mesh=mesh)
