"""ModelNet40 classification in the port against the JAX package: the
``data/modelnet.py`` copies give the JAX arrays, ``modelnet40_config`` and
the CLI's ``--config modelnet40`` match the JAX ones, a narrow
``gpn_modelnet40`` (the ``NARROW`` GPN spec of ``test_torch_gpn.py``)
gives the JAX logits layer by layer (``ClassifierHead`` at
``train=False``), a classification ``Trainer`` step on 4 clouds gives the
JAX trainer's loss, confusion matrix, cloud count and gradient (read from
Adam's first moment), a fully masked cloud counts nothing, and the train
CLI trains ``--config modelnet40`` from a pkl of (xyz, label) pairs on the
CPU with ``--restore --eval`` reproducing its test metrics.  Clouds have
256 points: every level takes the global search, as on the card."""
import dataclasses
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from jax.flatten_util import ravel_pytree

from pointcloudsegmentation_tpu.data import modelnet as jmodelnet
from pointcloudsegmentation_tpu.data import native as jnative
from pointcloudsegmentation_tpu.data.batching import pad_block, stack_blocks
from pointcloudsegmentation_tpu.train import cli as jcli
from pointcloudsegmentation_tpu.train import config as jconfig
from pointcloudsegmentation_tpu.train import model_zoo as jzoo
from pointcloudsegmentation_tpu.train.loop import Trainer as JTrainer
from pointcloudsegmentation_tpu.train.loop import TrainState as JState
from pointcloudsegmentation_tpu_torch import config as tconfig
from pointcloudsegmentation_tpu_torch.convert import (
    flax_train_state_to_torch, load_flax_params)
from pointcloudsegmentation_tpu_torch.data import modelnet as tmodelnet
from pointcloudsegmentation_tpu_torch.models import gpn as tgpn
from pointcloudsegmentation_tpu_torch.train import cli
from pointcloudsegmentation_tpu_torch.train import model_zoo as tzoo
from test_torch_archs import assert_close
from test_torch_data import assert_same
from test_torch_gpn import jax_anchors_once, narrow  # noqa: F401
from test_torch_model import random_params

torch.set_num_threads(1)
NP = 256
OVER = dict(data_num_points=NP, optim_epoch_steps=10,
            compute_dtype="float32")


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    """Both packages take the native covariance path."""
    jnative.ensure_built()
    assert jnative.available()


def pairs(seed, count, n=NP):
    """Seeded (xyz, label) pairs: Gaussian clouds stretched along the
    label's axis (the JAX ``tests/test_modelnet.py`` clouds, 40 labels)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(count):
        label = int(rng.randint(0, 40))
        xyz = rng.randn(n, 3).astype(np.float32)
        xyz[:, label % 3] *= 3.0
        out.append((xyz, label))
    return out


def batch_of(items, seed, masked=()):
    """The pairs prepared by the JAX package into one padded batch; the
    clouds at ``masked`` fully masked, as a test batch's padding."""
    rng = np.random.RandomState(seed)
    blocks = []
    for i, (xyz, label) in enumerate(items):
        c = jmodelnet.prepare_cloud(xyz, label, rng=rng)
        b = pad_block(c["xyz"], c["feats"], c["labels"], NP, rng)
        if i in masked:
            b["mask"] = np.zeros_like(b["mask"])
        blocks.append(b)
    return stack_blocks(blocks)


# -- data, config, CLI arguments ---------------------------------------------

def test_normalize_cloud():
    xyz = pairs(0, 1)[0][0] * 5 + 2
    got, want = tmodelnet.normalize_cloud(xyz), jmodelnet.normalize_cloud(xyz)
    assert_same(got, want)
    assert np.abs(np.linalg.norm(got, axis=1).max() - 1) < 1e-6


@pytest.mark.parametrize("augment", [False, True])
def test_prepare_cloud(augment):
    xyz, label = pairs(1, 1)[0]
    got = tmodelnet.prepare_cloud(xyz, label, rng=np.random.RandomState(3),
                                  augment_geometry=augment)
    want = jmodelnet.prepare_cloud(xyz, label, rng=np.random.RandomState(3),
                                   augment_geometry=augment)
    assert_same(got, want)
    assert got["feats"].shape == (NP, 9)
    assert (got["labels"] == label).all()


@pytest.mark.parametrize("split", ["train", "test"])
def test_clouds_from_pkl(tmp_path, split):
    path = tmp_path / "clouds.pkl"
    with open(path, "wb") as f:
        pickle.dump(pairs(2, 3), f)
    got = tmodelnet.clouds_from_pkl(split, str(path),
                                    rng=np.random.RandomState(4))
    want = jmodelnet.clouds_from_pkl(split, str(path),
                                     rng=np.random.RandomState(4))
    assert_same(got, want)
    assert tmodelnet.NUM_CLASSES == jmodelnet.NUM_CLASSES == 40


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def test_modelnet40_config_and_cli_args_match_jax():
    argv = ["--config", "modelnet40", "--epochs", "2", "--num-points", "512"]
    for got, want in ((tconfig.modelnet40_config(),
                       jconfig.modelnet40_config()),
                      (cli.build_cfg(cli.parse_args(argv)),
                       jcli.build_cfg(jcli.parse_args(argv)))):
        for name, value in _fields(got).items():
            if dataclasses.is_dataclass(value):
                assert _fields(value) == _fields(getattr(want, name)), name
            else:
                assert value == getattr(want, name), name
    assert tconfig.CONFIGS["modelnet40"] is tconfig.modelnet40_config


# -- the narrow classifier ---------------------------------------------------

@pytest.fixture(scope="module")
def case(narrow):  # noqa: F811
    jcfg = jconfig.modelnet40_config(**OVER)
    tcfg = tconfig.modelnet40_config(**OVER)
    batch = batch_of(pairs(5, 4), 5)
    jmodel = jzoo.build_model(jcfg)
    b0 = [batch[k][0] for k in ("xyz", "feats", "mask")]
    params = random_params(jmodel, *b0, seed=5)
    return dict(jcfg=jcfg, cfg=tcfg, batch=batch, jmodel=jmodel,
                params=params)


def _port(case):
    tmodel = tzoo.build_model(case["cfg"], device="cpu")
    load_flax_params(tmodel, case["params"])
    return tmodel


def test_classifier_layer_by_layer(case):
    """Every module of the port's encoder and head against the flax module
    of the same path, on each of the 4 clouds; logits [40]."""
    tmodel = _port(case)
    assert isinstance(tmodel, tzoo.ClassificationModel)
    assert isinstance(tmodel.encoder, tgpn.GPNClassModel)
    assert tmodel.head.class_fc1.in_features == tmodel.encoder.out_width
    jmodel, batch = case["jmodel"], case["batch"]
    fwd = jax.jit(lambda p, *b: jmodel.apply(
        p, *b, False, capture_intermediates=True, mutable=["intermediates"]))
    for i in range(4):
        b = [batch[k][i] for k in ("xyz", "feats", "mask")]
        logits, inter = fwd(case["params"], *b)
        outs = {}
        hooks = [mod.register_forward_hook(
            lambda m, a, out, name=name: outs.setdefault(name, out))
            for root in ("encoder", "head")
            for name, mod in getattr(tmodel, root).named_modules(
                prefix=root)]
        with torch.no_grad():
            got = tmodel(*(torch.from_numpy(x) for x in b))
        for h in hooks:
            h.remove()
        assert got.shape == (40,) and torch.isfinite(got).all()
        assert_close(got.numpy(), np.array(logits))
        assert "head.class_fc3" in outs and "encoder.stage2.gc_0" in outs
        for name, out in outs.items():
            node = inter["intermediates"]
            for part in name.split("."):
                node = node[part]
            want = node["__call__"][0]
            got_t = out if isinstance(out, tuple) else (out,)
            want = want if isinstance(want, tuple) else (want,)
            for g, w in zip(got_t, want):
                assert g.shape == w.shape, (name, g.shape, w.shape)
                assert_close(g.numpy(), np.array(w), name)


def test_classifier_head_dropout_needs_a_generator():
    head = tgpn.ClassifierHead(40, 16)
    x = torch.randn(1, 16)
    with pytest.raises(ValueError):
        head(x, train=True)
    a = head(x, True, torch.Generator().manual_seed(1))
    b = head(x, True, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and a.shape == (1, 40)


@pytest.fixture(scope="module")
def jax_step(case):
    """One JAX classification train step (dropout off) on the 4 clouds and
    its eval step on the batch with its last cloud fully masked."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        trainer = JTrainer(case["jcfg"])
        vec, _ = ravel_pytree(case["params"])
        state0 = JState(step=jnp.zeros((), jnp.int32),
                        params=case["params"],
                        opt_state=trainer.tx.init(vec))
        np_tree = lambda t: jax.tree_util.tree_map(np.array, t)  # noqa
        state0_np = np_tree(state0)   # the train step donates state0
        padded = batch_of(pairs(5, 4), 5, masked=(3,))
        _, em = trainer.eval_step(state0, padded, jax.random.PRNGKey(0))
        state1, m = trainer.train_step(state0, case["batch"],
                                       jax.random.PRNGKey(0))
        return dict(state0=state0_np, state1=np_tree(state1),
                    metrics=np_tree(m), eval=np_tree(em), padded=padded)


def test_classification_step_matches_jax(case, jax_step, monkeypatch):
    """Loss to rel 1e-4, the per-cloud confusion matrix and count equal,
    and the flat gradient of the mean CE over the 4 clouds to 1e-4: the
    port's ``loss_and_grad`` and the first moment of its step against the
    JAX step's (one Adam step from zero leaves mu at 0.1·grad)."""
    from pointcloudsegmentation_tpu_torch.train.loop import Trainer

    monkeypatch.setattr(tgpn.ClassifierHead, "_dropout",
                        lambda self, x, gen: x)
    trainer = Trainer(case["cfg"], device="cpu")
    state = trainer.init_state(state=flax_train_state_to_torch(
        jax_step["state0"], trainer.model))
    jm = jax_step["metrics"]
    loss, grad = trainer.loss_and_grad(state, case["batch"])
    np.testing.assert_allclose(float(loss), float(jm["loss"]), rtol=1e-4)
    want = flax_train_state_to_torch(jax_step["state1"], trainer.model)
    assert want.mu.abs().max() > 1e-3
    np.testing.assert_allclose(0.1 * grad.numpy(), want.mu.numpy(),
                               rtol=1e-4, atol=1e-5)
    state1, m = trainer.train_step(state, case["batch"])
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    np.testing.assert_array_equal(m["cm"].numpy(), jm["cm"])
    assert int(m["count"]) == int(jm["count"]) == 4
    assert int(m["correct"]) == int(jm["correct"])
    np.testing.assert_allclose(state1.mu.numpy(), want.mu.numpy(),
                               rtol=1e-4, atol=1e-5)


def test_a_masked_cloud_counts_nothing(case, jax_step):
    from pointcloudsegmentation_tpu_torch.train.loop import Trainer

    trainer = Trainer(case["cfg"], device="cpu")
    state = trainer.init_state(state=flax_train_state_to_torch(
        jax_step["state0"], trainer.model))
    _, m = trainer.eval_step(state, jax_step["padded"])
    jm = jax_step["eval"]
    assert int(m["count"]) == int(jm["count"]) == 3
    assert int(m["cm"].sum()) == 3
    np.testing.assert_array_equal(m["cm"].numpy(), jm["cm"])
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-4)


# -- the train CLI -----------------------------------------------------------

JAX_RECORD_KEYS = {"epoch", "train_loss", "lr", "miou", "oiou", "oacc",
                   "iou", "acc", "points_per_sec"}


def test_cli_modelnet40_from_pkl(narrow, tmp_path):  # noqa: F811
    """One epoch from a pkl of 6 (xyz, label) pairs (train clouds
    augmented), the test epoch's record with 40 classes, then ``--restore
    --eval`` gives the test metrics bit for bit."""
    data = tmp_path / "data"
    data.mkdir()
    with open(data / "clouds.pkl", "wb") as f:
        pickle.dump(pairs(7, 6), f)
    base = ["--config", "modelnet40", "--data-dir", str(data),
            "--num-points", str(NP), "--batch-size", "4", "--device", "cpu",
            "--checkpoint-dir", str(tmp_path / "ck")]
    state = cli.main(base + ["--epochs", "1", "--metrics-file",
                             str(tmp_path / "train.jsonl")])
    assert state.step == 2
    rec, = [json.loads(line) for line in open(tmp_path / "train.jsonl")]
    assert set(rec) == JAX_RECORD_KEYS and len(rec["iou"]) == 40
    assert np.isfinite(rec["train_loss"]) and 0 <= rec["oacc"] <= 1
    res = cli.main(base + ["--restore", "--eval", "--metrics-file",
                           str(tmp_path / "eval.jsonl")])
    ev, = [json.loads(line) for line in open(tmp_path / "eval.jsonl")]
    for key in ("miou", "oiou", "oacc", "iou", "acc"):
        assert ev[key] == rec[key], key
    assert float(res["oacc"]) == rec["oacc"]


def test_cli_modelnet40_synthetic(narrow, tmp_path):  # noqa: F811
    """Without a data dir the CLI trains on the toy blocks, as the JAX
    CLI's make_batches does."""
    cli.main(["--config", "modelnet40", "--synthetic", "--epochs", "1",
              "--steps-per-epoch", "1", "--batch-size", "2",
              "--num-points", str(NP), "--device", "cpu", "--metrics-file",
              str(tmp_path / "m.jsonl")])
    rec, = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    assert np.isfinite(rec["train_loss"]) and len(rec["iou"]) == 40
