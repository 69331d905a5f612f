"""The port's training step against the JAX trainer on the same numpy
inputs: loss, LR schedule, flat Adam with its non-finite guard, metrics,
train-state conversion, ``tiny_s3dis`` gradients and one whole
``Trainer.train_step``; plus the port's checkpoints, epoch loop and step
repeatability."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn
from jax.flatten_util import ravel_pytree
from test_torch_model import random_params

from pointcloudsegmentation_tpu.data import toy
from pointcloudsegmentation_tpu.train import metrics as jmetrics
from pointcloudsegmentation_tpu.train.config import s3dis_config as js3dis
from pointcloudsegmentation_tpu.train.config import \
    scannet_config as jscannet
from pointcloudsegmentation_tpu.train.loop import Trainer as JTrainer
from pointcloudsegmentation_tpu.train.loop import TrainState as JState
from pointcloudsegmentation_tpu.train.loop import \
    make_lr_schedule as jschedule
from pointcloudsegmentation_tpu.train.loop import seg_loss as jseg_loss
from pointcloudsegmentation_tpu.train.model_zoo import build_model as jbuild
from pointcloudsegmentation_tpu.train.loop import \
    seg_loss_terms as jseg_terms
from pointcloudsegmentation_tpu_torch.config import (S3DIS_CLASS_WEIGHTS,
                                                     scannet_config)
from pointcloudsegmentation_tpu_torch.config import s3dis_config as ts3dis
from pointcloudsegmentation_tpu_torch.convert import (
    flax_train_state_to_torch, ravel_layout)
from pointcloudsegmentation_tpu_torch.data.provider import device_prefetch
from pointcloudsegmentation_tpu_torch.models.layers import SegClassifier
from pointcloudsegmentation_tpu_torch.models.pointnet import \
    PointNetSegEncoder
from pointcloudsegmentation_tpu_torch.ops import hierarchy as thier
from pointcloudsegmentation_tpu_torch.train import loop as tloop
from pointcloudsegmentation_tpu_torch.train import metrics as tmetrics
from pointcloudsegmentation_tpu_torch.train.checkpoint import \
    CheckpointManager

torch.set_num_threads(1)

N = 512
TINY = dict(model="tiny_s3dis", data_num_points=N, data_caps=(256, 64),
            optim_epoch_steps=10, compute_dtype="float32")
TILE = dict(win_tile=64, win_window=64, search_chunk=256)


def _tiny_trainer(**kw):
    return tloop.Trainer(ts3dis(**{**TINY, **kw}), device="cpu", **TILE)


# -- loss, schedule, Adam, metrics ------------------------------------------

def _loss_case(case):
    rng = np.random.RandomState(7)
    c = 20 if case == "ignore0_shift" else 13
    logits = rng.randn(2, 300, c).astype(np.float32) * 3
    labels = rng.randint(0, c, (2, 300)).astype(np.int32)
    mask = rng.rand(2, 300) < 0.9
    weights, ignore = None, None
    if case == "s3dis_weights":
        weights = np.asarray(S3DIS_CLASS_WEIGHTS, np.float32)
    elif case == "ignore0_shift":
        labels = rng.randint(0, c + 1, (2, 300)).astype(np.int32)
        ignore = 0
    else:   # corrupt labels: outside [0, C) are excluded, not clamped
        labels[0, :20] = c + 3
        labels[1, :20] = -2
    return logits, labels, mask, weights, ignore


@pytest.mark.parametrize("case", ["s3dis_weights", "ignore0_shift",
                                  "corrupt_labels"])
def test_seg_loss_matches_jax(case):
    logits, labels, mask, weights, ignore = _loss_case(case)
    js, jw, jl, jv = jseg_terms(jnp.asarray(logits), jnp.asarray(labels),
                                jnp.asarray(mask), None if weights is None
                                else jnp.asarray(weights), ignore)
    tw = None if weights is None else torch.from_numpy(weights)
    ts, tw_, tl, tv = tloop.seg_loss_terms(
        torch.from_numpy(logits), torch.from_numpy(labels),
        torch.from_numpy(mask), tw, ignore)
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-6)
    np.testing.assert_allclose(float(tw_), float(jw), rtol=1e-6)
    np.testing.assert_array_equal(tl.numpy(), np.array(jl))
    np.testing.assert_array_equal(tv.numpy(), np.array(jv))
    jloss = jseg_loss(jnp.asarray(logits), jnp.asarray(labels),
                      jnp.asarray(mask), None if weights is None
                      else jnp.asarray(weights), ignore)[0]
    tloss = tloop.seg_loss(torch.from_numpy(logits),
                           torch.from_numpy(labels), torch.from_numpy(mask),
                           tw, ignore)[0]
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)


@pytest.mark.parametrize("step", [0, 1, 19, 20, 21, 59, 60, 139, 140, 10_000])
def test_lr_schedule_matches_optax(step):
    # decay every 20 steps by 0.5 from 1e-3, floor 1e-4 (reached at 80)
    kw = dict(optim_epoch_steps=10, optim_decay_epoch=2,
              optim_lr_clip=1e-4)
    want = float(jschedule(js3dis(**kw))(step))
    got = tloop.make_lr_schedule(ts3dis(**kw))(step)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_flat_adam_and_guard_match_optax():
    """Three Adam steps across a staircase edge, then a NaN step that the
    guard must revert, against the JAX trainer's ``_apply_update``."""
    kw = dict(optim_epoch_steps=1, optim_decay_epoch=2)
    schedule = jschedule(js3dis(**kw))
    jself = types.SimpleNamespace(tx=optax.adam(schedule))
    rng = np.random.RandomState(0)
    p0 = rng.randn(1000).astype(np.float32)
    jstate = JState(step=jnp.zeros((), jnp.int32), params=jnp.asarray(p0),
                    opt_state=jself.tx.init(jnp.asarray(p0)))
    tstate = tloop.TrainState(step=0, params=torch.from_numpy(p0.copy()),
                              mu=torch.zeros(1000), nu=torch.zeros(1000),
                              count=torch.zeros((), dtype=torch.int32))
    tsched = tloop.make_lr_schedule(ts3dis(**kw))
    for i in range(4):
        g = (rng.randn(1000) * 10.0 ** rng.uniform(-6, 1, 1000)).astype(
            np.float32)
        loss = np.float32(1.5)
        if i == 3:
            g[17] = np.nan
        jstate, jgood = JTrainer._apply_update(jself, jstate, jnp.asarray(g),
                                               jnp.asarray(loss))
        prev = tstate
        tstate, tgood = tloop.adam_update(tstate, torch.from_numpy(g),
                                          torch.tensor(loss), tsched)
        assert bool(tgood) == bool(jgood) == (i < 3)
        adam = jstate.opt_state[0]
        np.testing.assert_allclose(tstate.params.numpy(),
                                   np.array(jstate.params), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(tstate.mu.numpy(), np.array(adam.mu),
                                   rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(tstate.nu.numpy(), np.array(adam.nu),
                                   rtol=1e-6, atol=1e-20)
        assert int(tstate.count) == int(adam.count)
        assert tstate.step == int(jstate.step) == i + 1
    # the NaN step changed no param, moment or count
    assert torch.equal(tstate.params, prev.params)
    assert torch.equal(tstate.mu, prev.mu) and torch.equal(tstate.nu, prev.nu)
    assert int(tstate.count) == int(prev.count) == 3


def test_confusion_and_iou_match_jax():
    rng = np.random.RandomState(4)
    labels = rng.randint(0, 13, 5000)
    preds = np.where(rng.rand(5000) < 0.6, labels, rng.randint(0, 13, 5000))
    mask = rng.rand(5000) < 0.8
    want = np.array(jmetrics.confusion_matrix(
        jnp.asarray(labels), jnp.asarray(preds), 13, mask=jnp.asarray(mask)))
    got = tmetrics.confusion_matrix(torch.from_numpy(labels),
                                    torch.from_numpy(preds), 13,
                                    mask=torch.from_numpy(mask))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    jres = jmetrics.iou_from_confusion(want)
    tres = tmetrics.iou_from_confusion(got)
    for key in ("iou", "acc", "miou", "oiou", "oacc"):
        np.testing.assert_array_equal(tres[key], jres[key])


# -- checkpoints and the epoch loop ------------------------------------------

def _state(seed, p=64, step=0):
    g = torch.Generator().manual_seed(seed)
    return tloop.TrainState(step=step, params=torch.randn(p, generator=g),
                            mu=torch.randn(p, generator=g),
                            nu=torch.rand(p, generator=g),
                            count=torch.tensor(step, dtype=torch.int32))


def test_checkpoint_round_trip_and_best_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, best_keep=2)
    miou = {1: 0.30, 2: 0.50, 3: 0.20, 4: 0.45}
    states = {e: _state(e, step=10 * e) for e in miou}
    for e in miou:
        mgr.save(e, states[e], {"miou": miou[e], "loss": 1.0})
    assert mgr.latest_epoch() == 4
    assert mgr.best_epoch() == 2
    # per-epoch retention keeps the last 2, best/ keeps the best 2
    files = sorted(p.name for p in tmp_path.glob("epoch_*.pt"))
    assert files == ["epoch_000003.pt", "epoch_000004.pt"]
    best = sorted(p.name for p in (tmp_path / "best").glob("epoch_*.pt"))
    assert best == ["epoch_000002.pt", "epoch_000004.pt"]
    for got, want in ((mgr.restore(states[4]), states[4]),
                      (mgr.restore(epoch=3), states[3]),
                      (mgr.restore_best(states[4]), states[2])):
        assert got.step == want.step and int(got.count) == int(want.count)
        for f in ("params", "mu", "nu"):
            assert torch.equal(getattr(got, f), getattr(want, f))
    with pytest.raises(FileNotFoundError):
        mgr.restore(epoch=1)
    with pytest.raises(ValueError):
        mgr.restore(_state(0, p=8))
    mgr.close()
    # a new manager on the same directory sees the same best epochs
    again = CheckpointManager(str(tmp_path), keep=2, best_keep=2)
    assert again.best_epoch() == 2 and again.latest_epoch() == 4
    again.close()


def test_run_epoch_and_prefetch():
    trainer = _tiny_trainer()
    state = trainer.init_state(torch.Generator().manual_seed(0))
    batches = list(toy.toy_batches(2, batch_size=2, num_points=N,
                                   kind="room"))
    moved = list(device_prefetch(iter(batches), "cpu"))
    assert len(moved) == 2 and isinstance(moved[0]["xyz"], torch.Tensor)
    np.testing.assert_array_equal(moved[1]["feats"].numpy(),
                                  batches[1]["feats"])
    same, res = trainer.run_epoch(state, batches, train=False)
    assert same is state
    assert res["iou"].shape == (13,) and 0.0 <= res["miou"] <= 1.0
    assert res["points_per_sec"] > 0 and res["blocks_per_sec"] > 0
    state, res = trainer.run_epoch(state, batches, train=True)
    assert state.step == 2 and np.isfinite(res["loss"])


def test_train_step_repeats_and_guard_holds():
    """A step from one state, taken twice, gives bitwise-equal states (the
    dropout stream derives from (seed, step)); a batch with a NaN feature
    leaves params, moments and count unchanged."""
    trainer = _tiny_trainer(compute_dtype="bfloat16")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    batch = next(toy.toy_batches(1, batch_size=2, num_points=N,
                                 kind="room"))
    a, ma = trainer.train_step(state, batch)
    b, mb = trainer.train_step(state, batch)
    for f in ("params", "mu", "nu", "count"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(ma["loss"], mb["loss"]) and int(ma["skipped"]) == 0
    bad = dict(batch, feats=batch["feats"].copy())
    bad["feats"][1, 5, 0] = np.nan
    c, mc = trainer.train_step(a, bad)
    assert int(mc["skipped"]) == 1 and c.step == a.step + 1
    for f in ("params", "mu", "nu", "count"):
        assert torch.equal(getattr(c, f), getattr(a, f)), f


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from _tensors(v)
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))


def test_geometry_carries_no_gradient(monkeypatch):
    """Training and eval run with autograd live (never under inference
    mode), and the pyramid and the neighbor searches, functions of xyz
    alone, return nothing that requires grad."""
    seen = []

    def spy(fn, name):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            seen.append((name, torch.is_inference_mode_enabled(),
                         any(t.requires_grad for t in _tensors(out))))
            return out
        return wrapped

    monkeypatch.setattr(thier, "build_pyramid",
                        spy(thier.build_pyramid, "pyramid"))
    monkeypatch.setattr(PointNetSegEncoder, "_stage_neighborhoods",
                        spy(PointNetSegEncoder._stage_neighborhoods,
                            "search"))
    trainer = _tiny_trainer()
    state = trainer.init_state(torch.Generator().manual_seed(0))
    batch = next(toy.toy_batches(1, batch_size=1, num_points=N,
                                 kind="room"))
    _, grad = trainer.loss_and_grad(state, batch)
    assert torch.count_nonzero(grad) > 0
    trainer.eval_step(state, batch)
    names = [name for name, _, _ in seen]
    assert names == ["pyramid", "search", "search"] * 2
    assert not any(inf or req for _, inf, req in seen), seen


def test_scannet_ignore_label():
    cfg = scannet_config(model="tiny_s3dis", data_num_points=N,
                         data_caps=(256, 64), data_feat_dim=1,
                         optim_epoch_steps=10)
    trainer = tloop.Trainer(cfg, device="cpu", **TILE)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    batch = next(toy.toy_batches(1, batch_size=1, num_points=N,
                                 kind="room", num_classes=21, feat_dim=1))
    state, m = trainer.train_step(state, batch)
    assert np.isfinite(float(m["loss"]))
    n_ignored = int((batch["labels"] == 0).sum())
    assert int(m["count"]) == int(batch["mask"].sum()) - n_ignored


# -- against the JAX trainer -------------------------------------------------

@pytest.fixture(scope="module")
def jax_step():
    """One JAX ``tiny_s3dis`` train step (float32, tile = window = 64,
    dropout off) from random weights on 2 blocks, and the value and grad of
    the ``train=False`` loss on block 0; states as numpy trees."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PCS_WIN_WINDOW", "64")
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        trainer = JTrainer(js3dis(**TINY), search_chunk=256)
        assert trainer.model.encoder.win_tile == 64
        batch = next(toy.toy_batches(1, batch_size=2, num_points=N,
                                     kind="room", num_classes=13,
                                     feat_dim=12))
        params = random_params(trainer.model, batch["xyz"][0],
                               batch["feats"][0], batch["mask"][0], seed=3)
        vec, _ = ravel_pytree(params)
        state0 = JState(step=jnp.zeros((), jnp.int32), params=params,
                        opt_state=trainer.tx.init(vec))
        state0_np = jax.tree_util.tree_map(np.array, state0)
        cw = jnp.asarray(trainer.class_weights)

        def loss_fn(p):
            logits = trainer.model.apply(p, batch["xyz"][0],
                                         batch["feats"][0],
                                         batch["mask"][0], False)
            return jseg_loss(logits, batch["labels"][0], batch["mask"][0],
                             cw, None)[0]

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
        state1, metrics = trainer.train_step(state0, batch,
                                             jax.random.PRNGKey(0))
        return dict(batch=batch, state0=state0_np,
                    state1=jax.tree_util.tree_map(np.array, state1),
                    metrics=jax.tree_util.tree_map(np.array, metrics),
                    loss=float(loss), grads=np.array(ravel_pytree(grads)[0]))


def test_convert_train_state_after_one_step(jax_step):
    trainer = _tiny_trainer()
    st = flax_train_state_to_torch(jax_step["state1"], trainer.model)
    js = jax_step["state1"]
    _, unravel = ravel_pytree(js.params)
    adam = js.opt_state[0]
    assert st.step == 1 and int(st.count) == int(adam.count) == 1
    mu_tree, nu_tree = unravel(adam.mu), unravel(adam.nu)
    layout = ravel_layout(trainer.model)
    assert len(layout) == len(jax.tree_util.tree_leaves(js.params))
    for leaf in layout:
        def at(tree):
            for name in ("params",) + leaf.path:
                tree = tree[name]
            return np.array(tree)
        for flat, tree in ((st.params, js.params), (st.mu, mu_tree),
                           (st.nu, nu_tree)):
            got = flat[leaf.offset:leaf.offset + leaf.size].numpy()
            np.testing.assert_array_equal(got.reshape(leaf.shape), at(tree))
    # the params load into the model's own layout (kernels transposed)
    w = next(leaf for leaf in layout
             if leaf.key == "encoder.feats0.fc_0_nbr.weight").view(st.params)
    np.testing.assert_array_equal(
        w.numpy(), np.array(js.params["params"]["encoder"]["feats0"]
                            ["fc_0_nbr"]["kernel"]).T)
    # any leaf missing or mis-sized raises
    bad = jax.tree_util.tree_map(lambda a: a, js.params)
    del bad["params"]["head"]["class_mlp3"]["bias"]
    with pytest.raises(KeyError):
        flax_train_state_to_torch(js.replace(params=bad), trainer.model)
    short = (adam._replace(mu=adam.mu[:-1]),) + tuple(js.opt_state[1:])
    with pytest.raises(ValueError):
        flax_train_state_to_torch(js.replace(opt_state=short), trainer.model)


def test_tiny_grads_match_jax(jax_step):
    """The ``train=False`` loss and every parameter's gradient of
    ``tiny_s3dis`` at 512 points, float32, to 1e-4."""
    trainer = _tiny_trainer()
    state = trainer.init_state(
        state=flax_train_state_to_torch(jax_step["state0"], trainer.model))
    block0 = {k: v[:1] for k, v in jax_step["batch"].items()}
    loss, grad = trainer.loss_and_grad(state, block0, train=False)
    np.testing.assert_allclose(float(loss), jax_step["loss"], rtol=1e-4)
    want = jax_step["grads"]
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(grad.numpy(), want, rtol=1e-4, atol=1e-4)


def test_train_step_matches_jax(jax_step, monkeypatch):
    """One whole ``Trainer.train_step`` on 2 blocks with dropout off on
    both sides: loss to rel 1e-4, confusion matrix and counts equal, the
    accumulated 2-block gradient to 1e-4 (read from Adam's first moment,
    which one step from zero leaves at 0.1·grad), and every param within
    2.1·lr of the JAX step's (Adam turns reduction-order noise in near-zero
    gradients into steps of up to lr either way)."""
    monkeypatch.setattr(SegClassifier, "_dropout", lambda self, x, gen: x)
    trainer = _tiny_trainer()
    state = trainer.init_state(
        state=flax_train_state_to_torch(jax_step["state0"], trainer.model))
    state, m = trainer.train_step(state, jax_step["batch"])
    jm = jax_step["metrics"]
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    np.testing.assert_array_equal(m["cm"].numpy(), jm["cm"])
    assert int(m["correct"]) == int(jm["correct"])
    assert int(m["count"]) == int(jm["count"])
    assert int(m["skipped"]) == int(jm["skipped"]) == 0
    want = flax_train_state_to_torch(jax_step["state1"], trainer.model)
    assert want.mu.abs().max() > 1e-3
    for leaf in trainer.layout:
        np.testing.assert_allclose(leaf.view(state.mu).numpy(),
                                   leaf.view(want.mu).numpy(), rtol=1e-4,
                                   atol=0.1 * 1e-4, err_msg=leaf.key)
    lr = trainer.cfg.optim.lr_init
    assert (state.params - want.params).abs().max().item() <= 2.1 * lr
    assert state.step == want.step and int(state.count) == int(want.count)


def test_pointnet_scannet_step_and_grads_match_jax():
    """``Trainer(scannet_config(...))`` builds ``pointnet_scannet`` with no
    model override and takes a step; with converted weights its
    ``train=False`` loss (label 0 ignored, the rest shifted) and its flat
    gradient match the JAX trainer's model at 512 points, float32, to
    1e-4."""
    over = dict(data_num_points=N, data_caps=(256, 64),
                compute_dtype="float32")
    trainer = tloop.Trainer(scannet_config(**over), device="cpu")
    assert trainer.cfg.model == "pointnet_scannet"
    batch = next(toy.toy_batches(1, batch_size=1, num_points=N, kind="room",
                                 num_classes=21, feat_dim=1))
    jcfg = jscannet(**over)
    jmodel = jbuild(jcfg)
    params = random_params(jmodel, batch["xyz"][0], batch["feats"][0],
                           batch["mask"][0], seed=6)

    def loss_fn(p):
        logits = jmodel.apply(p, batch["xyz"][0], batch["feats"][0],
                              batch["mask"][0], False)
        return jseg_loss(logits, batch["labels"][0], batch["mask"][0], None,
                         0)[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    flat = np.array(ravel_pytree(grads)[0])
    vec = ravel_pytree(params)[0]
    opt = optax.adam(jschedule(jcfg)).init(vec)
    state = trainer.init_state(state=flax_train_state_to_torch(
        JState(step=np.int32(0), params=params, opt_state=opt),
        trainer.model))
    tloss, tgrad = trainer.loss_and_grad(state, batch, train=False)
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-4)
    assert np.abs(flat).max() > 1e-2
    np.testing.assert_allclose(tgrad.numpy(), flat, rtol=1e-4, atol=1e-4)
    state, m = trainer.train_step(state, batch)
    assert state.step == 1 and int(m["skipped"]) == 0
    assert np.isfinite(float(m["loss"]))
