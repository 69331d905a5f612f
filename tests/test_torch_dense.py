"""The dense pipeline of Semantic3D in the port against the JAX package:
``search.knn_in_support`` slot for slot (masked queries and support,
duplicated support points, fewer valid support points than K, a support
wider than 1024 columns over several query chunks, where the JAX search
takes its tiled top-k), ``DenseFeats`` and ``dense_semantic3d`` at full
width in float32 with converted flax weights (layer by layer, logits, and
every gradient against ``jax.grad``), the numpy copies (``dense_batches``,
the dense read of block pkls, the ``Provider``'s dense fields) as exact
arrays, one ``Trainer`` step of a narrow dense model against the JAX
trainer, and the train CLI.  Floats hold 1e-4 after dividing by max(1,
the largest |JAX output|) (``assert_close``).

The model tests put the points on a 1/1024 m lattice.  Off the lattice,
float32 near-ties at the 16th dense neighbor are decided by rounding, and
XLA rounds the same JAX search differently inside the whole model's
program than alone: on a random dense batch of 1024 sampled points, 3 of
16,384 slots of the JAX model's own search differ from the standalone JAX
``knn_in_support``, which the port matches slot for slot (the tests
below).  On the lattice every squared distance is exact whatever the
order of the sums (``_lattice`` checks the bound), so a tie is a true tie
and both take the lower index.  A coarser lattice (1/64 m) also makes
exact ties in a conv's max, where a framework that rounds the two equal
slots apart routes the whole gradient to one of them (measured: one tie in
the last conv, and gradients 3e-3 apart upstream of it)."""
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

from pointcloudsegmentation_tpu.data import native as jnative
from pointcloudsegmentation_tpu.data import provider as jprovider
from pointcloudsegmentation_tpu.data import semantic3d as jsemantic3d
from pointcloudsegmentation_tpu.data import toy as jtoy
from pointcloudsegmentation_tpu.models import dense as jdense
from pointcloudsegmentation_tpu.models import pointnet as jpointnet
from pointcloudsegmentation_tpu.ops import search as jsearch
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
from pointcloudsegmentation_tpu_torch.data import io_util as tio
from pointcloudsegmentation_tpu_torch.data import provider as tprovider
from pointcloudsegmentation_tpu_torch.data import semantic3d as tsemantic3d
from pointcloudsegmentation_tpu_torch.data import toy as ttoy
from pointcloudsegmentation_tpu_torch.eval.interpolate import \
    eval_scene_probs
from pointcloudsegmentation_tpu_torch.models import dense as tdense
from pointcloudsegmentation_tpu_torch.models import pointnet as tpointnet
from pointcloudsegmentation_tpu_torch.models.layers import SegClassifier
from pointcloudsegmentation_tpu_torch.ops import search as tsearch
from pointcloudsegmentation_tpu_torch.train import cli
from pointcloudsegmentation_tpu_torch.train import loop as tloop
from pointcloudsegmentation_tpu_torch.train import model_zoo as tzoo
from test_torch_archs import assert_close
from test_torch_data import assert_same
from test_torch_model import random_params, random_tree

torch.set_num_threads(1)
N, DENSE, CAPS = 1024, 4, (1024, 256)
LATTICE = 1024.0
DENSE_KEYS = ("xyz", "feats", "mask", "dense_xyz", "dense_feats",
              "dense_mask")


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    """The JAX package's grid downsample takes its native path only where
    its library is built; build it so both packages take the same one."""
    jnative.ensure_built()
    assert jnative.available()


def _t(a):
    return torch.from_numpy(np.array(a))


# -- knn_in_support -----------------------------------------------------------

def test_tiled_top_k_is_the_exact_top_k():
    """The JAX search's tiled top-k (tiles of 512) selects the same slots
    in the same order as one exact top-k with ties to the lower index, so
    the port runs the exact one: 20 score arrays of [8, 3000] with
    heavy ties and 30% of the columns at -1e30."""
    rng = np.random.RandomState(0)
    both = jax.jit(lambda s: (jsearch._tiled_top_k(s, 16),
                              jax.lax.top_k(s, 16)))
    for _ in range(20):
        score = -rng.randint(0, 40, (8, 3000)).astype(np.float32) / 8.0
        score[:, rng.rand(3000) < 0.3] = -1e30
        (tv, ti), (ev, ei) = both(score)
        np.testing.assert_array_equal(np.array(ti), np.array(ei))
        np.testing.assert_array_equal(np.array(tv), np.array(ev))
        _, pi = tsearch._topk_smallest(_t(-score), 16)
        np.testing.assert_array_equal(pi.numpy(), np.array(ei))


def _cloud(rng, n, frac_valid, dup=0):
    xyz = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    if dup:
        xyz[n - dup:] = xyz[:dup]      # duplicated points: exact ties
    mask = rng.rand(n) < frac_valid
    return xyz, mask


@pytest.mark.parametrize("nq,ns,k,chunk,valid_s", [
    (300, 700, 16, 128, 0.7),     # masked queries and support, duplicates
    (200, 64, 16, 64, 5),         # 5 valid support points for K=16
    (2500, 3000, 16, 1024, 0.9),  # JAX's tiled top-k, three query chunks
])
def test_knn_in_support_matches_jax(nq, ns, k, chunk, valid_s):
    rng = np.random.RandomState(nq)
    q, qm = _cloud(rng, nq, 0.9)
    s, sm = _cloud(rng, ns, 1.0, dup=ns // 5)
    if isinstance(valid_s, int):
        sm[:] = False
        sm[rng.choice(ns, valid_s, replace=False)] = True
    else:
        sm &= rng.rand(ns) < valid_s
    want = [np.array(a) for a in jsearch.knn_in_support(q, qm, s, sm, k,
                                                       chunk=chunk)]
    idx, d2, valid = tsearch.knn_in_support(_t(q), _t(qm), _t(s), _t(sm), k,
                                            chunk=chunk)
    assert idx.dtype == torch.int32 and d2.dtype == torch.float32
    np.testing.assert_array_equal(valid.numpy(), want[2])
    np.testing.assert_array_equal(idx.numpy(), want[0])
    np.testing.assert_allclose(d2.numpy(), want[1], rtol=1e-6, atol=0)
    v = valid.numpy()
    assert not v[~qm].any()
    assert (idx.numpy()[~v] == 0).all() and (d2.numpy()[~v] == 0).all()
    if isinstance(valid_s, int):
        assert (v[qm].sum(1) == valid_s).all()
    else:
        assert v[qm].all()


# -- the model ----------------------------------------------------------------

def _lattice(batch):
    """The batch's coordinates rounded to a 1/1024 m lattice (module
    docstring)."""
    out = dict(batch)
    for key in ("xyz", "dense_xyz"):
        k = np.round(batch[key] * LATTICE)
        # |q|^2 + |s|^2 in units of LATTICE^-2 stays below 2^24: exact
        assert 6 * np.abs(k).max() ** 2 < 2 ** 24
        out[key] = k.astype(np.float32) / np.float32(LATTICE)
    return out


def _dense_batch(n=N, batch_size=1, seed=0):
    b = next(jtoy.dense_batches(1, batch_size, num_points=n,
                                dense_factor=DENSE, seed=seed,
                                num_classes=8, feat_dim=13))
    b = _lattice(b)
    b["mask"][:, -24:] = False         # padded sampled points
    b["dense_mask"][:, -100:] = False  # and padded dense points
    return b


def test_dense_feats_matches_jax():
    """``DenseFeats`` alone against the flax module: the pooled
    descriptor and the concat; a masked sampled point pools to 0."""
    b = {k: v[0] for k, v in _dense_batch(512).items()}
    args = [b[k] for k in ("dense_xyz", "dense_feats", "dense_mask", "xyz",
                           "feats", "mask")]
    jm = jdense.DenseFeats()
    params = random_tree(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), *args)), 2)
    want = np.array(jax.jit(lambda p: jm.apply(p, *args))(params))
    tm = tdense.DenseFeats(13)
    load_flax_params(tm, params)
    with torch.no_grad():
        got = tm(*(_t(a) for a in args)).numpy()
    assert got.shape == (512, 48 + 13)
    assert_close(got, want, "DenseFeats")
    assert (got[~b["mask"], :48] == 0).all()


def _cfgs(**over):
    over = dict(dict(model="dense_semantic3d", data_num_points=N,
                     data_caps=CAPS, data_ignore_label=0), **over)
    return (jconfig.semantic3d_config(compute_dtype="float32", **over),
            tconfig.semantic3d_config(compute_dtype="float32", **over))


@pytest.fixture(scope="module")
def case():
    """The JAX dense model at full width with random weights on one
    block: its logits, every module's output, and the value and grad of
    the ``train=False`` loss (label 0 ignored, as the port's preset
    does), from one program."""
    jcfg, tcfg = _cfgs()
    jmodel = jzoo.build_model(jcfg)
    b = {k: v[0] for k, v in _dense_batch().items()}
    args = [b[k] for k in DENSE_KEYS]
    params = random_params(jmodel, *args, seed=5)

    def loss(p):
        (logits, inter) = jmodel.apply(p, *args, False,
                                       capture_intermediates=True,
                                       mutable=["intermediates"])
        return jseg_loss(logits, b["labels"], b["mask"], None, 0)[0], \
            (logits, inter)

    (lv, (logits, inter)), grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(params)
    return dict(params=params, args=args, labels=b["labels"],
                logits=np.array(logits), inter=inter["intermediates"],
                loss=float(lv), grads=np.array(ravel_pytree(grads)[0]),
                jcfg=jcfg, cfg=tcfg)


def _port(case):
    tmodel = tzoo.build_model(case["cfg"], device="cpu")
    load_flax_params(tmodel, case["params"])
    return tmodel


def test_dense_model_settings():
    """The dense build: ``SEMANTIC3D_DILATE_ARCH`` on 48 + 13 input
    features, per-point overflow slots, the unfactored head; the other
    keys keep the pool of 256 and the factored head."""
    model = tzoo.build_model(tconfig.semantic3d_config(
        model="dense_semantic3d"), None, "cpu")
    enc = model.encoder
    assert isinstance(model, tzoo.DenseSegModel)
    assert enc.arch is tpointnet.SEMANTIC3D_DILATE_ARCH
    assert enc.ov_pool_size == 0 and enc.head_dim is None
    assert enc.embed0.fc_embed.in_features == 61
    assert not model.head.premixed
    assert model.head.class_mlp1.in_features == enc.out_width
    assert not hasattr(model, "diffusion")
    assert model.extra_keys == DENSE_KEYS[3:]
    other = tzoo.build_model(tconfig.semantic3d_config(
        model="pointnet_semantic3d_dilate"), None, "cpu")
    assert other.encoder.ov_pool_size == tpointnet.OV_POOL_SIZE == 256
    assert other.encoder.head_dim == tpointnet.HEAD_DIM


def test_dense_layer_by_layer(case):
    """Every module of ``dense_feats``, the encoder and the head against
    the flax module of the same path."""
    tmodel = _port(case)
    outs = {}
    for root in ("dense_feats", "encoder", "head"):
        for name, mod in getattr(tmodel, root).named_modules(prefix=root):
            mod.register_forward_hook(
                lambda m, a, out, name=name: outs.setdefault(name, out))
    with torch.no_grad():
        tmodel(*(_t(a) for a in case["args"]))
    assert "dense_feats.dense_feats.fc_out" in outs
    assert "encoder.feats12" in outs and "head.class_mlp1" in outs
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


def test_dense_end_to_end(case):
    tmodel = _port(case)
    with torch.no_grad():
        got = tmodel(*(_t(a) for a in case["args"])).numpy()
    assert got.shape == (N, 8) and np.isfinite(got).all()
    assert_close(got, case["logits"], "logits")
    np.testing.assert_array_equal(got.argmax(1), case["logits"].argmax(1))
    # the sweep passes the dense fields by name
    blk = dict(zip(DENSE_KEYS, case["args"]))
    _, probs = eval_scene_probs(tmodel, [blk], extra_keys=DENSE_KEYS[3:])
    want = np.array(jax.nn.softmax(case["logits"], -1))[blk["mask"]]
    np.testing.assert_allclose(probs, want, atol=1e-5, rtol=0)


def test_dense_grads_match_jax(case):
    """The ``train=False`` loss and every parameter's gradient (through
    ``DenseFeats`` too) against ``jax.grad``, to 1e-4."""
    opt = optax.adam(jschedule(case["jcfg"])).init(
        ravel_pytree(case["params"])[0])
    trainer = tloop.Trainer(case["cfg"], device="cpu")
    state = trainer.init_state(state=flax_train_state_to_torch(
        JState(step=np.int32(0), params=case["params"], opt_state=opt),
        trainer.model))
    batch = {k: a[None] for k, a in zip(DENSE_KEYS, case["args"])}
    batch["labels"] = case["labels"][None]
    loss, grad = trainer.loss_and_grad(state, batch, train=False)
    np.testing.assert_allclose(float(loss), case["loss"], rtol=1e-4)
    want = case["grads"]
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(grad.numpy(), want, rtol=1e-4, atol=1e-4)
    for leaf in trainer.layout:
        if leaf.key.startswith("dense_feats."):
            assert leaf.view(grad).abs().max() > 0, leaf.key


@pytest.mark.parametrize("key", ["dense_semantic3d", "context_semantic3d"])
def test_use_diffusion_is_refused(key):
    """The JAX build ignores ``diffusion_steps`` for the two keys (no
    tail); the port raises."""
    cfg = tconfig.semantic3d_config(model=key, diffusion_steps=3)
    with pytest.raises(ValueError, match="no diffusion tail"):
        tzoo.build_model(cfg, None, "cpu")
    argv = ["--config", "semantic3d", "--model", key, "--use-diffusion",
            "3", "--device", "cpu", "--synthetic"]
    with pytest.raises(ValueError, match="no diffusion tail"):
        cli.main(argv if key == "dense_semantic3d" else argv[:-1]
                 + ["--data-dir", "."])


# -- the numpy copies ---------------------------------------------------------

@pytest.mark.parametrize("num_points,factor", [(256, 4), (96, 2)])
def test_dense_batches_give_the_jax_arrays(num_points, factor):
    want = list(jtoy.dense_batches(2, 3, num_points=num_points,
                                   dense_factor=factor, seed=3,
                                   num_classes=8, feat_dim=13))
    got = list(ttoy.dense_batches(2, 3, num_points=num_points,
                                  dense_factor=factor, seed=3,
                                  num_classes=8, feat_dim=13))
    assert_same(got, want)
    assert set(got[0]) == {"xyz", "feats", "labels", "mask", "dense_xyz",
                           "dense_feats", "dense_mask"}


def _scan(rng, n=8000):
    pts = np.concatenate([
        rng.uniform(0, 12, (n, 2)), rng.uniform(0, 5, (n, 1)),
        rng.uniform(0, 2000, (n, 1)),
        rng.randint(0, 255, (n, 3))], 1).astype(np.float32)
    return pts, rng.randint(0, 9, n).astype(np.int32)


@pytest.fixture(scope="module")
def block_pkl(tmp_path_factory):
    """A pkl of ``semantic3d.save_blocks`` blocks (the JAX test's scan,
    ``tests/test_datasets.py:151``)."""
    pts, labels = _scan(np.random.RandomState(0))
    blocks = jsemantic3d.sample_training_blocks(
        pts, labels, block_size=10.0, stride=5.0, ds_stride=0.2, min_pn=32,
        rng=np.random.RandomState(1), covar_nn_size=1.0)
    path = str(tmp_path_factory.mktemp("dense") / "blocks.pkl")
    jsemantic3d.save_blocks(path, blocks)
    return path


@pytest.mark.parametrize("model", ["train", "test"])
def test_dense_blocks_from_pkl_give_the_jax_arrays(block_pkl, model):
    """The dense read through ``model_zoo.read_fn_for`` (pkl read, then
    ``dense_blocks_from_list``) against the JAX
    ``dense_blocks_from_pkl``: flips, jitter, the 0.5 m subset."""
    want = jsemantic3d.dense_blocks_from_pkl(
        model, block_pkl, sample_stride=0.5, rng=np.random.RandomState(2))
    got = tsemantic3d.dense_blocks_from_list(
        model, tio.read_pkl(block_pkl), sample_stride=0.5,
        rng=np.random.RandomState(2))
    assert_same(got, want)
    assert len(got[0]["xyz"]) < len(got[0]["dense_xyz"])
    cfg = tconfig.semantic3d_config(model="dense_semantic3d")
    fn = tzoo.read_fn_for(cfg, "semantic3d")
    assert fn.args[0] is tsemantic3d.dense_blocks_from_list


@pytest.mark.parametrize("model", ["train", "test"])
def test_provider_dense_batches(block_pkl, model):
    """The Provider's dense fields (the JAX test's capacities, 256 sampled
    and 1024 dense points) on the same subsamples as the JAX Provider."""
    rng = np.random.RandomState(4)
    reads = {"j": functools.partial(jsemantic3d.dense_blocks_from_pkl,
                                    sample_stride=0.5,
                                    rng=np.random.RandomState(4)),
             "t": lambda m, f: tsemantic3d.dense_blocks_from_list(
                 m, tio.read_pkl(f), sample_stride=0.5, rng=rng)}
    out = {}
    for name, prov_mod in (("j", jprovider), ("t", tprovider)):
        prov = prov_mod.Provider([block_pkl], model, 2, reads[name], 256,
                                 seed=6, dense_num_points=1024)
        out[name] = list(prov)
        prov.close()
    assert out["t"][0]["dense_xyz"].shape == (2, 1024, 3)
    assert_same(out["t"], out["j"])
    # 0 = 4 x num_points, as in JAX
    assert tprovider.Provider([], "train", 2, None, 256).dense_num_points \
        == 1024


# -- a narrow dense model through the trainers and the CLI --------------------

def _narrow_arch(mod):
    """A 2-stage, 3-conv PointNet arch (the JAX ``tiny_s3dis``'s) from the
    ``Arch`` classes of ``mod``, with an embed before every conv as the
    Semantic3D arch has."""
    return mod.Arch(stages=(
        mod.StageSpec(rescale=0.3, convs=(
            mod.ConvSpec(radius=0.3, k=8, embed=8, fc_dims=(4, 4), out=8),
            mod.ConvSpec(radius=0.4, min_radius=0.3, k=6, embed=8,
                         fc_dims=(4, 4), out=8),
        ), pool_fc_dims=(4, 4), pool_out=8),
        mod.StageSpec(rescale=0.9, convs=(
            mod.ConvSpec(radius=0.9, k=8, embed=8, fc_dims=(4, 4), out=8),
        ), pool_fc_dims=None),
    ), global_dims=(8, 8), global_out=16)


@pytest.fixture
def narrow(monkeypatch):
    """Both registries' dense encoders narrow, and the port's Semantic3D
    preset at caps (256, 64) for the CLI."""
    monkeypatch.setattr(jzoo, "SEMANTIC3D_DILATE_ARCH",
                        _narrow_arch(jpointnet))
    pipeline = tzoo._PIPELINES["dense_semantic3d"]
    monkeypatch.setitem(
        tzoo._PIPELINES, "dense_semantic3d", pipeline._replace(
            encoder=functools.partial(tzoo._dense_encoder,
                                      arch=_narrow_arch(tpointnet))))
    monkeypatch.setitem(tconfig.CONFIGS, "semantic3d", functools.partial(
        tconfig.semantic3d_config, data_caps=(256, 64)))


def test_trainer_step_matches_jax(narrow, monkeypatch):
    """One ``train_step`` on 2 blocks of 512 sampled and 2048 dense
    points, dropout off on both sides: loss to rel 1e-4, confusion matrix
    and counts equal, the accumulated gradient (Adam's first moment) to
    1e-4."""
    jcfg, tcfg = _cfgs(data_num_points=512, data_caps=(256, 64))
    batch = _dense_batch(512, batch_size=2, seed=7)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        jtrainer = JTrainer(jcfg)
        params = random_params(jtrainer.model,
                               *(batch[k][0] for k in DENSE_KEYS), seed=6)
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
    with pytest.raises(KeyError, match="dense_xyz"):
        trainer.train_step(state, {k: v for k, v in batch.items()
                                   if not k.startswith("dense")})


def test_cli_trains_dense(narrow, block_pkl, tmp_path):
    """``--model dense_semantic3d``: one synthetic step with its test
    epoch, and one epoch from ``semantic3d.save_blocks`` pkls through the
    dense read."""
    base = ["--config", "semantic3d", "--model", "dense_semantic3d",
            "--batch-size", "1", "--num-points", "512", "--device", "cpu",
            "--epochs", "1"]
    cli.main(base + ["--synthetic", "--steps-per-epoch", "1",
                     "--metrics-file", str(tmp_path / "s.jsonl")])
    rec, = [json.loads(line) for line in open(tmp_path / "s.jsonl")]
    assert np.isfinite(rec["train_loss"]) and len(rec["iou"]) == 8
    pkl_dir = tmp_path / "pkl"
    pkl_dir.mkdir()
    (pkl_dir / "scan.pkl").write_bytes(open(block_pkl, "rb").read())
    cli.main(base + ["--data-dir", str(pkl_dir), "--metrics-file",
                     str(tmp_path / "d.jsonl")])
    rec, = [json.loads(line) for line in open(tmp_path / "d.jsonl")]
    assert np.isfinite(rec["train_loss"])
