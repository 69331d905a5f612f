"""The context pipeline of Semantic3D in the port against the JAX package:
``ContextNet`` on a context cloud's own pyramid, ``context_semantic3d`` at
full width in float32 with converted flax weights (256 block points and 32
context points, the JAX ``tests/test_train.py:256`` sizes; layer by layer,
logits, every gradient against ``jax.grad``), logits that follow the
block's points when they are permuted with their context indices, the
numpy copies (``pad_block(point_fields=)``, ``pad_context`` with and
without its cap, ``context_cloud``, ``context_indices``,
``prepare_context_scene``, the context read of its pkls, the
``Provider``'s context fields) as exact arrays, ``context_indices``
raising where the native library fails, one ``Trainer`` step of a narrow
context model against the JAX trainer, and the train CLI.  Context
coordinates are block-relative and go negative, as
``prepare_context_scene`` stores them.  Floats hold 1e-4 after dividing
by max(1, the largest |JAX output|) (``assert_close``)."""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn
from jax.flatten_util import ravel_pytree

from pointcloudsegmentation_tpu.data import batching as jbatching
from pointcloudsegmentation_tpu.data import native as jnative
from pointcloudsegmentation_tpu.data import provider as jprovider
from pointcloudsegmentation_tpu.data import semantic3d as jsemantic3d
from pointcloudsegmentation_tpu.data import toy as jtoy
from pointcloudsegmentation_tpu.models import context as jcontext
from pointcloudsegmentation_tpu.models import ecd as jecd
from pointcloudsegmentation_tpu.ops import hierarchy as jhier
from pointcloudsegmentation_tpu.train import config as jconfig
from pointcloudsegmentation_tpu.train import model_zoo as jzoo
from pointcloudsegmentation_tpu.train.loop import Trainer as JTrainer
from pointcloudsegmentation_tpu.train.loop import TrainState as JState
from pointcloudsegmentation_tpu.train.loop import \
    make_lr_schedule as jschedule
from pointcloudsegmentation_tpu.train.loop import seg_loss as jseg_loss
from pointcloudsegmentation_tpu_torch import config as tconfig
from pointcloudsegmentation_tpu_torch.convert import (
    flax_train_state_to_torch, load_flax_params)
from pointcloudsegmentation_tpu_torch.data import batching as tbatching
from pointcloudsegmentation_tpu_torch.data import io_util as tio
from pointcloudsegmentation_tpu_torch.data import native as tnative
from pointcloudsegmentation_tpu_torch.data import provider as tprovider
from pointcloudsegmentation_tpu_torch.data import semantic3d as tsemantic3d
from pointcloudsegmentation_tpu_torch.eval.interpolate import \
    eval_scene_probs
from pointcloudsegmentation_tpu_torch.models import context as tcontext
from pointcloudsegmentation_tpu_torch.models import ecd as tecd
from pointcloudsegmentation_tpu_torch.models.layers import SegClassifier
from pointcloudsegmentation_tpu_torch.ops import hierarchy as thier
from pointcloudsegmentation_tpu_torch.train import cli
from pointcloudsegmentation_tpu_torch.train import loop as tloop
from pointcloudsegmentation_tpu_torch.train import model_zoo as tzoo
from test_torch_archs import assert_close
from test_torch_data import assert_same
from test_torch_model import random_params, random_tree

torch.set_num_threads(1)
N, NC, CAPS = 256, 32, (128, 32)
KEYS = ("xyz", "feats", "mask", "ctx_xyz", "ctx_feats", "ctx_mask",
        "ctx_idx")


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    """The JAX package's ``context_indices`` and grid downsample take
    their native paths only where its library is built."""
    jnative.ensure_built()
    assert jnative.available()


def _t(a):
    return torch.from_numpy(np.array(a))


def _context(rng, nc=NC, n=N, fdim=tcontext.CTX_FEAT_DIM):
    """A block-relative context cloud (±25 m, so negative coordinates),
    its last 3 points padding, and per-point indices into its valid
    points."""
    cx = rng.uniform(-25, 25, (nc, 3)).astype(np.float32)
    cf = rng.randn(nc, fdim).astype(np.float32)
    cm = np.ones(nc, bool)
    cm[-3:] = False
    cx[~cm] = 0.0
    ci = rng.randint(0, nc - 3, n).astype(np.int32)
    return cx, cf, cm, ci


def _batch(batch_size=1, seed=0):
    b = next(jtoy.toy_batches(1, batch_size, num_points=N, kind="room",
                              num_classes=8, feat_dim=13, seed=seed))
    rng = np.random.RandomState(seed + 100)
    ctx = [_context(rng) for _ in range(batch_size)]
    for i, key in enumerate(KEYS[3:]):
        b[key] = np.stack([c[i] for c in ctx])
    b["mask"][:, -20:] = False
    return b


def test_context_net_matches_jax():
    """``ContextNet`` alone on a 64-point context cloud's unsorted
    pyramid (5 m voxels, cap 32 over a 50 m block): the flax module's
    output, [64, 1132]."""
    cx, cf, cm, _ = _context(np.random.RandomState(1), nc=64)
    jpyr = jhier.build_pyramid(jnp.asarray(cx), jnp.asarray(cm), (5.0,),
                               (32,), 50.0)
    jm = jcontext.ContextNet()
    params = random_tree(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jpyr, jnp.asarray(cf))), 3)
    want = np.array(jax.jit(lambda p, pyr: jm.apply(p, pyr, cf))(params,
                                                                  jpyr))
    tm = tcontext.ContextNet()
    load_flax_params(tm, params)
    tpyr = thier.build_pyramid(_t(cx), _t(cm), (5.0,), (32,), 50.0)
    with torch.no_grad():
        got = tm(tpyr, _t(cf)).numpy()
    assert got.shape == (64, tm.out_width) == (64, 1132)
    assert_close(got, want, "ContextNet")


def _cfgs(**over):
    over = dict(dict(model="context_semantic3d", data_num_points=N,
                     data_caps=CAPS, data_ignore_label=0), **over)
    return (jconfig.semantic3d_config(compute_dtype="float32", **over),
            tconfig.semantic3d_config(compute_dtype="float32", **over))


@pytest.fixture(scope="module")
def case():
    """The JAX context model at full width with random weights on one
    block: its logits, every module's output, and the value and grad of
    the ``train=False`` loss (label 0 ignored, as the port's preset
    does), from one program."""
    jcfg, tcfg = _cfgs()
    jmodel = jzoo.build_model(jcfg)
    b = {k: v[0] for k, v in _batch().items()}
    args = [jnp.asarray(b[k]) for k in KEYS]
    params = random_params(jmodel, *args, seed=5)

    def loss(p):
        logits, inter = jmodel.apply(p, *args, False,
                                     capture_intermediates=True,
                                     mutable=["intermediates"])
        return jseg_loss(logits, b["labels"], b["mask"], None, 0)[0], \
            (logits, inter)

    (lv, (logits, inter)), grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(params)
    return dict(params=params, block=b, labels=b["labels"],
                logits=np.array(logits), inter=inter["intermediates"],
                loss=float(lv), grads=np.array(ravel_pytree(grads)[0]),
                jcfg=jcfg, cfg=tcfg)


def _port(case):
    tmodel = tzoo.build_model(case["cfg"], device="cpu")
    load_flax_params(tmodel, case["params"])
    return tmodel


def _forward(model, b):
    with torch.no_grad():
        return model(*(_t(b[k]) for k in KEYS)).numpy()


def test_context_model_settings():
    """The build: the S3DIS ECD net on the block's 13 features, the
    ``ContextNet`` of 4 context features, the unfactored head on [main
    global ‖ context] columns; the JAX model's defaults."""
    model = tzoo.build_model(tconfig.semantic3d_config(
        model="context_semantic3d"), None, "cpu")
    assert isinstance(model, tcontext.ContextFusionModel)
    assert isinstance(model.encoder, tecd.ECDSegModel)
    assert model.encoder.specs == tecd.S3DIS_ECD_SPEC
    assert model.encoder.stage0.fc_0.in_features == 16 + 13
    assert model.context.stage0.fc_0.in_features == 16 + 4
    assert not model.head.premixed
    assert model.head.class_mlp1.in_features == \
        model.encoder.out_width + 1132
    assert model.extra_keys == KEYS[3:]
    jm = jcontext.ContextFusionModel(encoder=None, num_classes=8)
    assert (model.ctx_voxel_size, model.ctx_cap, model.ctx_block_size) == \
        (jm.ctx_voxel_size, jm.ctx_cap, jm.ctx_block_size) == (5.0, 512,
                                                               50.0)
    assert (model.voxel_sizes, model.caps, model.block_size) == (
        (0.25, 0.75), (5120, 1280), 10.0)
    for ours, theirs in ((tcontext.ContextNet.STAGE0,
                          jcontext.ContextNet.stage0),
                         (tcontext.ContextNet.STAGE1,
                          jcontext.ContextNet.stage1)):
        assert vars(ours) == vars(theirs)


def test_context_layer_by_layer(case):
    """Every module of the main branch, ``ContextNet`` and the head
    against the flax module of the same path."""
    tmodel = _port(case)
    outs = {}
    for root in ("encoder", "context", "head"):
        for name, mod in getattr(tmodel, root).named_modules(prefix=root):
            mod.register_forward_hook(
                lambda m, a, out, name=name: outs.setdefault(name, out))
    _forward(tmodel, case["block"])
    assert "context.stage1.final_gfc" in outs and "head.class_mlp1" in outs
    for name, out in outs.items():
        node = case["inter"]
        for part in name.split("."):
            node = node[part]
        want = node["__call__"][0]
        got = out if isinstance(out, tuple) else (out,)
        want = want if isinstance(want, tuple) else (want,)
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            assert g.shape == w.shape, (name, g.shape, w.shape)
            assert_close(g.numpy(), np.array(w), name)


def test_context_end_to_end(case):
    tmodel = _port(case)
    got = _forward(tmodel, case["block"])
    assert got.shape == (N, 8) and np.isfinite(got).all()
    assert_close(got, case["logits"], "logits")
    np.testing.assert_array_equal(got.argmax(1), case["logits"].argmax(1))
    # the sweep passes the context fields by name
    _, probs = eval_scene_probs(tmodel, [case["block"]],
                                extra_keys=KEYS[3:])
    want = np.array(jax.nn.softmax(case["logits"], -1))[
        case["block"]["mask"]]
    np.testing.assert_allclose(probs, want, atol=1e-5, rtol=0)


def test_context_logits_follow_the_points(case):
    """The block's points permuted together with their context indices:
    the logits permute with them (the Morton sort carries ``ctx_idx``;
    JAX ``tests/test_components.py:48``); context indices read at random
    instead change them."""
    tmodel = _port(case)
    b = case["block"]
    base = _forward(tmodel, b)
    perm = np.random.RandomState(3).permutation(N)
    pb = dict(b, **{k: b[k][perm] for k in ("xyz", "feats", "mask",
                                             "ctx_idx")})
    assert_close(_forward(tmodel, pb), base[perm], "permuted")
    shuffled = dict(b, ctx_idx=np.random.RandomState(4).permutation(
        b["ctx_idx"]))
    assert not np.allclose(_forward(tmodel, shuffled), base, atol=1e-3)


def test_context_grads_match_jax(case):
    """The ``train=False`` loss and every parameter's gradient (through
    the context gather into ``ContextNet`` too) against ``jax.grad``, to
    1e-4."""
    opt = optax.adam(jschedule(case["jcfg"])).init(
        ravel_pytree(case["params"])[0])
    trainer = tloop.Trainer(case["cfg"], device="cpu")
    state = trainer.init_state(state=flax_train_state_to_torch(
        JState(step=np.int32(0), params=case["params"], opt_state=opt),
        trainer.model))
    batch = {k: case["block"][k][None] for k in KEYS}
    batch["labels"] = case["labels"][None]
    loss, grad = trainer.loss_and_grad(state, batch, train=False)
    np.testing.assert_allclose(float(loss), case["loss"], rtol=1e-4)
    want = case["grads"]
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(grad.numpy(), want, rtol=1e-4, atol=1e-4)
    for leaf in trainer.layout:
        if leaf.key.startswith("context."):
            assert leaf.view(grad).abs().max() > 0, leaf.key


# -- the numpy copies ---------------------------------------------------------

def test_pad_block_point_fields_give_the_jax_arrays():
    """Context indices ride the block's subsample, and are zero-padded
    on a short block."""
    rng = np.random.RandomState(0)
    xyz = rng.rand(300, 3).astype(np.float32)
    feats = rng.rand(300, 4).astype(np.float32)
    labels = rng.randint(0, 8, 300).astype(np.int32)
    fields = {"ctx_idx": rng.randint(0, 40, 300).astype(np.int32)}
    for n in (128, 400):
        want = jbatching.pad_block(xyz, feats, labels, n,
                                   np.random.RandomState(1),
                                   point_fields=fields)
        got = tbatching.pad_block(xyz, feats, labels, n,
                                  np.random.RandomState(1),
                                  point_fields=fields)
        assert_same(got, want)
        assert got["ctx_idx"].dtype == np.int32


@pytest.mark.parametrize("m,cap", [(40, 64), (200, 64)])
def test_pad_context_gives_the_jax_arrays(m, cap):
    """Under the cap: zero padding; over it (200 points, cap 64): the 64
    points nearest the block center, remapped indices, and the block
    points whose context point was dropped moved to the nearest kept
    one."""
    rng = np.random.RandomState(m)
    cx = rng.uniform(-25, 25, (m, 3)).astype(np.float32)
    cf = rng.randn(m, 4).astype(np.float32)
    bxyz = rng.uniform(-5, 5, (500, 3)).astype(np.float32)
    ci = rng.randint(0, m, 500).astype(np.int32)
    want = jbatching.pad_context(cx, cf, ci, cap, bxyz)
    got = tbatching.pad_context(cx, cf, ci, cap, bxyz)
    assert_same(got, want)
    assert (got["ctx_idx"] < min(m, cap)).all()
    if m > cap:
        kept = np.argsort(cx[:, 0] ** 2 + cx[:, 1] ** 2, kind="stable")[:cap]
        moved = ~np.isin(ci, kept)
        assert moved.any()
        d2 = ((bxyz[moved][:, None] - cx[kept][None]) ** 2).sum(-1)
        np.testing.assert_array_equal(got["ctx_idx"][moved], d2.argmin(1))


def _scan(rng, n=20000):
    """The JAX test's scan (``tests/test_datasets.py:243``): 60 x 60 m."""
    xyz = np.stack([rng.rand(n) * 60.0, rng.rand(n) * 60.0,
                    rng.rand(n) * 8.0], 1).astype(np.float32)
    irgb = np.concatenate([rng.rand(n, 1) * 100.0,
                           rng.randint(0, 255, (n, 3))], 1)
    points = np.concatenate([xyz, irgb], 1).astype(np.float32)
    return points, rng.randint(0, 9, n).astype(np.int32)


@pytest.fixture(scope="module")
def scene():
    points, labels = _scan(np.random.RandomState(0))
    want = jsemantic3d.prepare_context_scene(
        points, labels, min_pn=64, rng=np.random.RandomState(0))
    got = tsemantic3d.prepare_context_scene(
        points, labels, min_pn=64, rng=np.random.RandomState(0))
    return points, want, got


def test_context_cloud_and_indices_give_the_jax_arrays(scene):
    points, _, _ = scene
    cloud = tsemantic3d.context_cloud(points, 5.0)
    assert_same(cloud, jsemantic3d.context_cloud(points, 5.0))
    rel = cloud[:, :3] - np.float32([20, 20, 0])
    bxyz = points[:3000, :3] - np.float32([20, 20, 0])
    got = tsemantic3d.context_indices(bxyz, rel)
    assert_same(got, jsemantic3d.context_indices(bxyz, rel))
    d2 = ((bxyz[:, None] - rel[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(got, d2.argmin(1))


def test_prepare_context_scene_gives_the_jax_arrays(scene):
    _, want, got = scene
    assert len(got) > 4
    assert_same(got, want)
    for b in got:
        assert b["ctx_feats"].shape == (len(b["ctx_xyz"]), 4)
        assert (b["ctx_xyz"][:, :2] < 0).any()
        d2 = ((b["xyz"][:, None] - b["ctx_xyz"][None]) ** 2).sum(-1)
        np.testing.assert_array_equal(b["ctx_idx"], d2.argmin(1))


def test_context_indices_raise_without_the_native_library(monkeypatch):
    """No dense argmin takes the native k-NN's place."""
    def fail():
        raise RuntimeError("native library did not build")

    monkeypatch.setattr(tnative, "_load", fail)
    xyz = np.zeros((4, 3), np.float32)
    with pytest.raises(RuntimeError, match="did not build"):
        tsemantic3d.context_indices(xyz, xyz)


@pytest.fixture(scope="module")
def context_pkl(scene, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("context") / "scene.pkl")
    jsemantic3d.save_blocks(path, scene[1][:3])
    return path


@pytest.mark.parametrize("model", ["train", "test"])
def test_context_blocks_from_pkl_give_the_jax_arrays(context_pkl, model):
    """The context read through ``model_zoo.read_fn_for``: flips of
    block and context cloud together, jitter on the block only."""
    want = jsemantic3d.context_blocks_from_pkl(
        model, context_pkl, rng=np.random.RandomState(2))
    got = tsemantic3d.context_blocks_from_list(
        model, tio.read_pkl(context_pkl), rng=np.random.RandomState(2))
    assert_same(got, want)
    cfg = tconfig.semantic3d_config(model="context_semantic3d")
    assert tzoo.read_fn_for(cfg, "semantic3d").args[0] is \
        tsemantic3d.context_blocks_from_list


@pytest.mark.parametrize("model", ["train", "test"])
def test_provider_context_batches(context_pkl, model):
    """The Provider's context fields at 512 block points and the JAX
    capacity of 512 context points, and at a cap of 16 (the oversize
    remap), on the same subsamples as the JAX Provider."""
    for cap in (512, 16):
        rng = np.random.RandomState(4)
        reads = {
            "j": functools.partial(jsemantic3d.context_blocks_from_pkl,
                                   rng=np.random.RandomState(4)),
            "t": lambda m, f: tsemantic3d.context_blocks_from_list(
                m, tio.read_pkl(f), rng=rng)}
        out = {}
        for name, mod in (("j", jprovider), ("t", tprovider)):
            prov = mod.Provider([context_pkl], model, 2, reads[name], 512,
                                seed=6, ctx_num_points=cap)
            out[name] = list(prov)
            prov.close()
        assert out["t"][0]["ctx_xyz"].shape == (2, cap, 3)
        assert_same(out["t"], out["j"])
    # the default capacity is the context model's cap, as in JAX
    assert tprovider.Provider([], "train", 2, None, 256).ctx_num_points \
        == tcontext.ContextFusionModel.ctx_cap == tcontext.CTX_CAP == 512


# -- a narrow context model through the trainers and the CLI ------------------

NARROW_MAIN = (
    jecd.ECDStageSpec(radius=0.3, k=8, gxyz_dim=4, gc_dims=(4,),
                      gfc_dims=(4,), final_dim=8, dxyz_scale=0.25),
    jecd.ECDStageSpec(radius=0.9, k=8, gxyz_dim=4, gc_dims=(8,),
                      gfc_dims=(8,), final_dim=8, dxyz_scale=0.75),
    jecd.ECDStageSpec(radius=2.0, k=8, gxyz_dim=4, gc_dims=(8,),
                      gfc_dims=(8,), final_dim=8, dxyz_scale=1.5),
)
NARROW_CTX = (
    jecd.ECDStageSpec(radius=5.0, k=8, gxyz_dim=4, gc_dims=(4,),
                      gfc_dims=(4,), final_dim=8, dxyz_scale=5.0),
    jecd.ECDStageSpec(radius=15.0, k=8, gxyz_dim=4, gc_dims=(8,),
                      gfc_dims=(8,), final_dim=8, dxyz_scale=50.0),
)


def _torch_spec(sp):
    return tecd.ECDStageSpec(**vars(sp))


@pytest.fixture
def narrow(monkeypatch):
    """Both registries' context models with narrow main and context
    stages, and the port's Semantic3D preset at caps (128, 32)."""
    monkeypatch.setattr(jzoo, "S3DIS_ECD_SPEC", NARROW_MAIN)
    monkeypatch.setattr(jcontext, "ContextNet", functools.partial(
        jcontext.ContextNet, stage0=NARROW_CTX[0], stage1=NARROW_CTX[1]))
    pipeline = tzoo._PIPELINES["context_semantic3d"]
    monkeypatch.setitem(
        tzoo._PIPELINES, "context_semantic3d", pipeline._replace(
            encoder=functools.partial(tecd.ECDSegModel, specs=tuple(
                _torch_spec(sp) for sp in NARROW_MAIN))))
    monkeypatch.setattr(tcontext.ContextNet, "STAGE0",
                        _torch_spec(NARROW_CTX[0]))
    monkeypatch.setattr(tcontext.ContextNet, "STAGE1",
                        _torch_spec(NARROW_CTX[1]))
    monkeypatch.setitem(tconfig.CONFIGS, "semantic3d", functools.partial(
        tconfig.semantic3d_config, data_caps=CAPS))


def test_trainer_step_matches_jax(narrow, monkeypatch):
    """One ``train_step`` on 2 blocks of 256 points with 32 context points
    each, dropout off on both sides: loss to rel 1e-4, confusion matrix
    and counts equal, the accumulated gradient (Adam's first moment) to
    1e-4."""
    jcfg, tcfg = _cfgs()
    batch = _batch(batch_size=2, seed=7)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        jtrainer = JTrainer(jcfg)
        params = random_params(jtrainer.model, *(jnp.asarray(batch[k][0])
                                                 for k in KEYS), seed=6)
        vec, _ = ravel_pytree(params)
        state0 = JState(step=jnp.zeros((), jnp.int32), params=params,
                        opt_state=jtrainer.tx.init(vec))
        state0_np = jax.tree_util.tree_map(np.array, state0)
        state1, jm = jtrainer.train_step(state0, batch,
                                         jax.random.PRNGKey(0))
        state1 = jax.tree_util.tree_map(np.array, state1)
        jm = jax.tree_util.tree_map(np.array, jm)
    monkeypatch.setattr(SegClassifier, "_dropout", lambda self, x, gen: x)
    trainer = tloop.Trainer(tcfg, device="cpu")
    assert trainer.num_params == vec.size
    state = trainer.init_state(state=flax_train_state_to_torch(
        state0_np, trainer.model))
    state, m = trainer.train_step(state, batch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    np.testing.assert_array_equal(m["cm"].numpy(), jm["cm"])
    assert int(m["count"]) == int(jm["count"])
    assert int(m["correct"]) == int(jm["correct"])
    want = flax_train_state_to_torch(state1, trainer.model)
    assert want.mu.abs().max() > 1e-3
    np.testing.assert_allclose(state.mu.numpy(), want.mu.numpy(),
                               rtol=1e-4, atol=1e-5)


def test_cli_refuses_synthetic_context():
    """The JAX CLI cannot train this key on synthetic blocks (ROADMAP
    R7); the port says what it needs instead."""
    with pytest.raises(ValueError, match="--data-dir.*prepare_context_scene"):
        cli.main(["--config", "semantic3d", "--model", "context_semantic3d",
                  "--synthetic", "--device", "cpu"])


def test_cli_trains_context_and_restores(narrow, context_pkl, tmp_path):
    """``--model context_semantic3d --data-dir`` on pkls of
    ``prepare_context_scene`` blocks: one epoch with its test epoch and a
    checkpoint, then ``--restore --eval`` gives the test metrics bit for
    bit."""
    pkl_dir = tmp_path / "pkl"
    pkl_dir.mkdir()
    (pkl_dir / "scene.pkl").write_bytes(open(context_pkl, "rb").read())
    base = ["--config", "semantic3d", "--model", "context_semantic3d",
            "--data-dir", str(pkl_dir), "--batch-size", "2", "--num-points",
            str(N), "--device", "cpu", "--checkpoint-dir",
            str(tmp_path / "ck")]
    cli.main(base + ["--epochs", "1", "--metrics-file",
                     str(tmp_path / "t.jsonl")])
    rec, = [json.loads(line) for line in open(tmp_path / "t.jsonl")]
    assert np.isfinite(rec["train_loss"]) and len(rec["iou"]) == 8
    cli.main(base + ["--restore", "--eval", "--metrics-file",
                     str(tmp_path / "e.jsonl")])
    ev, = [json.loads(line) for line in open(tmp_path / "e.jsonl")]
    for key in ("miou", "oiou", "oacc", "iou", "acc"):
        assert ev[key] == rec[key], key
