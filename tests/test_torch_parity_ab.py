"""The port's windowed-vs-exact A/B (``parity_ab``) against
``scripts/parity_ab.py``: the exact arm's ``Trainer(windowed=False)`` step
against the JAX trainer traced with ``PCS_DISABLE_WINDOWED=1`` on
``tiny_s3dis`` at 1024 points (where the two arms differ), the config and
the ``--hard`` blocks the script builds, both arms through ``main`` with
the JAX script's JSON keys and deltas, ``--arms``, and
``bench_fused_conv --reps``."""
import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from jax.flatten_util import ravel_pytree
from test_torch_model import random_params

from pointcloudsegmentation_tpu.data import synth_rooms as jsynth
from pointcloudsegmentation_tpu.data import toy
from pointcloudsegmentation_tpu.train.config import s3dis_config as js3dis
from pointcloudsegmentation_tpu.train.config import \
    scannet_config as jscannet
from pointcloudsegmentation_tpu.train.loop import Trainer as JTrainer
from pointcloudsegmentation_tpu.train.loop import TrainState as JState
from pointcloudsegmentation_tpu_torch import bench_fused_conv, parity_ab
from pointcloudsegmentation_tpu_torch.config import s3dis_config
from pointcloudsegmentation_tpu_torch.convert import \
    flax_train_state_to_torch
from pointcloudsegmentation_tpu_torch.models.layers import SegClassifier
from pointcloudsegmentation_tpu_torch.train.loop import Trainer

torch.set_num_threads(1)

N = 1024
TINY = dict(model="tiny_s3dis", data_num_points=N, compute_dtype="float32")
CHUNK = min(2048, N)                       # the script's search_chunk
# the JAX script's keys for each arm and for the whole run
ARM_KEYS = {"curve", "final_miou", "best_miou"}
RUN_KEYS = {"config", "windowed", "exact", "delta_final_miou",
            "delta_best_miou"}


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.fixture(scope="module")
def jax_exact_step():
    """One JAX ``tiny_s3dis`` train step with the exact search
    (``PCS_DISABLE_WINDOWED=1`` at trace time), float32, dropout off, on
    2 room blocks of 1024 points from random weights."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PCS_DISABLE_WINDOWED", "1")
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        trainer = JTrainer(js3dis(**TINY), search_chunk=CHUNK)
        batch = next(toy.toy_batches(1, batch_size=2, num_points=N,
                                     kind="room", num_classes=13,
                                     feat_dim=12))
        params = random_params(trainer.model, batch["xyz"][0],
                               batch["feats"][0], batch["mask"][0], seed=3)
        vec, _ = ravel_pytree(params)
        state0 = JState(step=jnp.zeros((), jnp.int32), params=params,
                        opt_state=trainer.tx.init(vec))
        state0_np = jax.tree_util.tree_map(np.array, state0)
        state1, metrics = trainer.train_step(state0, batch,
                                             jax.random.PRNGKey(0))
        return dict(batch=batch, state0=state0_np,
                    state1=jax.tree_util.tree_map(np.array, state1),
                    metrics=jax.tree_util.tree_map(np.array, metrics))


def _port_step(jax_exact_step, windowed):
    trainer = Trainer(s3dis_config(**TINY), device="cpu",
                      search_chunk=CHUNK, windowed=windowed)
    state = trainer.init_state(state=flax_train_state_to_torch(
        jax_exact_step["state0"], trainer.model))
    return (trainer,) + trainer.train_step(state, jax_exact_step["batch"])


def test_exact_arm_step_matches_jax(jax_exact_step, monkeypatch):
    """``Trainer(windowed=False).train_step`` against the JAX step with the
    exact search: loss to rel 1e-4, confusion matrix equal, Adam's first
    moment (0.1·grad after one step) to 1e-4, every param within 2.1·lr;
    the port's windowed step on the same weights and blocks gives another
    loss, so the arms really differ at this size."""
    monkeypatch.setattr(SegClassifier, "_dropout", lambda self, x, gen: x)
    trainer, state, m = _port_step(jax_exact_step, windowed=False)
    jm = jax_exact_step["metrics"]
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    np.testing.assert_array_equal(m["cm"].numpy(), jm["cm"])
    assert int(m["count"]) == int(jm["count"])
    assert int(m["skipped"]) == int(jm["skipped"]) == 0
    want = flax_train_state_to_torch(jax_exact_step["state1"], trainer.model)
    assert want.mu.abs().max() > 1e-3
    for leaf in trainer.layout:
        np.testing.assert_allclose(leaf.view(state.mu).numpy(),
                                   leaf.view(want.mu).numpy(), rtol=1e-4,
                                   atol=0.1 * 1e-4, err_msg=leaf.key)
    lr = trainer.cfg.optim.lr_init
    assert (state.params - want.params).abs().max().item() <= 2.1 * lr
    _, _, mw = _port_step(jax_exact_step, windowed=True)
    gap = abs(float(mw["loss"]) - float(m["loss"]))
    assert gap > 1e-3 * float(m["loss"]), (float(mw["loss"]),
                                           float(m["loss"]))


@pytest.mark.parametrize("config", ["s3dis", "scannet"])
def test_cfg_is_the_jax_scripts(config):
    """At 1024 points the config keeps the preset's voxel caps (4096,
    1024), field by field what ``scripts/parity_ab.py`` builds."""
    args = parity_ab.parse_args(["--num-points", str(N), "--config", config])
    got = parity_ab.make_cfg(args, 7)
    if config == "scannet":
        want = jscannet(model="pointnet_scannet", data_num_points=N,
                        data_num_classes=13, optim_epoch_steps=7)
    else:
        want = js3dis(model="pointnet_s3dis", data_num_points=N,
                      optim_epoch_steps=7)
    assert got.data.caps == (4096, 1024)
    for name, value in _fields(got).items():
        if dataclasses.is_dataclass(value):
            assert _fields(value) == _fields(getattr(want, name)), name
        else:
            assert value == getattr(want, name), name


def _run(tmp_path, monkeypatch, *extra):
    """``main`` on 1 train and 1 test room for 1 epoch of ``tiny_s3dis``
    at 1024 points on the CPU; returns the saved JSON and the blocks each
    arm was handed.  Each arm trains and tests on the first batch of 2 of
    those blocks: a CPU step takes ~2 s (the search's top-k), and a room
    gives 16-33 blocks."""
    seen = []
    real = parity_ab.run_arm

    def run_arm(arm, train_blocks, test_blocks, *a):
        seen.append((arm, train_blocks, test_blocks))
        return real(arm, train_blocks[:2], test_blocks[:2], *a)

    monkeypatch.setattr(parity_ab, "run_arm", run_arm)
    out = tmp_path / "ab.json"
    res = parity_ab.main(["--model", "tiny_s3dis", "--num-points", str(N),
                          "--train-rooms", "1", "--test-rooms", "1",
                          "--epochs", "1", "--batch", "2",
                          "--device", "cpu",
                          "--out", str(out), *extra])
    saved = json.load(open(out))
    assert saved == json.loads(json.dumps(res))
    return saved, seen


@pytest.fixture(scope="module")
def hard_run(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        return _run(tmp_path_factory.mktemp("hard"), mp, "--hard")


@pytest.mark.parametrize("hard", [False, True])
def test_main_runs_both_arms(hard, hard_run, tmp_path, monkeypatch):
    """Both arms by default, the JAX script's keys, the deltas the arms'
    differences, a finite last train loss a epoch, no ``card`` on the
    CPU; both arms handed the same blocks."""
    saved, seen = hard_run if hard else _run(tmp_path, monkeypatch)
    assert RUN_KEYS <= set(saved) and "card" not in saved
    assert saved["config"]["hard"] is hard
    assert [s[0] for s in seen] == ["windowed", "exact"]
    assert seen[0][1] is seen[1][1] and seen[0][2] is seen[1][2]
    for arm in ("windowed", "exact"):
        a = saved[arm]
        assert ARM_KEYS <= set(a) and len(a["curve"]) == 1
        assert a["final_miou"] == a["curve"][0]["miou"]
        assert 0.0 <= a["best_miou"] <= 1.0
        assert np.isfinite(a["curve"][0]["last_train_loss"])
    w, e = saved["windowed"], saved["exact"]
    assert saved["delta_final_miou"] == w["final_miou"] - e["final_miou"]
    assert saved["delta_best_miou"] == w["best_miou"] - e["best_miou"]


def test_hard_blocks_are_the_jax_scripts(hard_run):
    """``--hard`` builds ``synth_rooms.room_blocks(..., hard=True,
    rooms_per_scene=2)`` of the JAX package, for the train seed (0) and
    the test seed (10,000)."""
    _, seen = hard_run
    kw = dict(hard=True, rooms_per_scene=2)
    want = (jsynth.room_blocks(np.random.RandomState(0), 1, model="train",
                               **kw),
            jsynth.room_blocks(np.random.RandomState(10_000), 1,
                               model="test", **kw))
    got = seen[0][1:]
    plain = jsynth.room_blocks(np.random.RandomState(0), 1, model="train")
    assert len(got[0]) != len(plain) or any(
        len(a["xyz"]) != len(b["xyz"]) for a, b in zip(got[0], plain))
    for g_blocks, w_blocks in zip(got, want):
        assert len(g_blocks) == len(w_blocks) > 0
        for g, w in zip(g_blocks, w_blocks):
            assert g.keys() == w.keys()
            for key in w:
                np.testing.assert_array_equal(g[key], w[key], key)


def test_arms_picks_the_arms(tmp_path, monkeypatch):
    """``--arms exact`` alone trains the exact arm and writes no delta; a
    name other than ``windowed`` or ``exact`` is refused."""
    monkeypatch.setattr(parity_ab, "run_arm", lambda arm, *a: {
        "arm": arm, "best_miou": 0.5, "final_miou": 0.25})
    monkeypatch.setattr(parity_ab, "make_blocks",
                        lambda args: ([{"xyz": np.zeros((1, 3))}], []))
    out = str(tmp_path / "ab.json")
    res = parity_ab.main(["--arms", "exact", "--device", "cpu",
                          "--out", out])
    assert res["exact"]["arm"] == "exact" and "windowed" not in res
    assert not {"delta_final_miou", "delta_best_miou"} & set(res)
    with pytest.raises(SystemExit):
        parity_ab.main(["--arms", "windowed", "global", "--device", "cpu",
                        "--out", out])


def test_bench_reps_reaches_time_arms(monkeypatch):
    """``--reps`` (the JAX script's default 16) is the timed calls of each
    arm: a card bench hands it to ``time_arms``."""
    seen = []
    fake = types.SimpleNamespace(
        feats=types.SimpleNamespace(is_cuda=True),
        wn=types.SimpleNamespace(lidx=torch.zeros(8, 4)))
    monkeypatch.setattr(bench_fused_conv, "setup", lambda level, dev: fake)
    monkeypatch.setattr(bench_fused_conv, "time_arms",
                        lambda b, iters=20: seen.append(iters) or {})
    monkeypatch.setattr(bench_fused_conv, "cross_check",
                        lambda b: (0.0, 1.0))
    monkeypatch.setattr("pointcloudsegmentation_tpu_torch.utils.timing.card",
                        lambda: "card")
    assert bench_fused_conv.main(["--reps", "5"]) == 0
    assert bench_fused_conv.main([]) == 0
    assert seen == [5, 16]
