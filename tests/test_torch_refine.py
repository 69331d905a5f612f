"""The refine cascade of the port against the JAX package: the class-pure
segments (``compute_segments(key2=)``, ``voxelize_with_labels``,
``build_class_pyramid``) as exact integers, including voxels that two
classes share; ``refine_s3dis`` at full width on a 1024-point block
(caps (1024, 256): the class pyramid's 256 voxels take the global search)
layer by layer, both rows end to end and every gradient against
``jax.grad``; one ``Trainer`` step of a narrow cascade against the JAX
trainer; the refine row in ``eval_scene_probs``, the scene eval and the
train CLI.  Floats hold 1e-4 after dividing by max(1, the largest |JAX
output|) (``assert_close``)."""
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

import pointcloudsegmentation_tpu.models as jmodels
from pointcloudsegmentation_tpu.data import toy
from pointcloudsegmentation_tpu.models import ecd as jecd
from pointcloudsegmentation_tpu.ops import hierarchy as jhier
from pointcloudsegmentation_tpu.ops import morton as jmorton
from pointcloudsegmentation_tpu.ops import voxelize as jvox
from pointcloudsegmentation_tpu.train import config as jconfig
from pointcloudsegmentation_tpu.train import model_zoo as jzoo
from pointcloudsegmentation_tpu.train.loop import Trainer as JTrainer
from pointcloudsegmentation_tpu.train.loop import TrainState as JState
from pointcloudsegmentation_tpu.train.loop import \
    make_lr_schedule as jschedule
from pointcloudsegmentation_tpu.train.loop import seg_loss as jseg_loss
from pointcloudsegmentation_tpu_torch import config as tconfig
from pointcloudsegmentation_tpu_torch import interpolate
from pointcloudsegmentation_tpu_torch.convert import (
    flax_train_state_to_torch, load_flax_params)
from pointcloudsegmentation_tpu_torch.eval.interpolate import \
    eval_scene_probs
from pointcloudsegmentation_tpu_torch.models import ecd as tecd
from pointcloudsegmentation_tpu_torch.models import template as ttemplate
from pointcloudsegmentation_tpu_torch.models.layers import SegClassifier
from pointcloudsegmentation_tpu_torch.ops import hierarchy as thier
from pointcloudsegmentation_tpu_torch.ops import voxelize as tvox
from pointcloudsegmentation_tpu_torch.train import cli
from pointcloudsegmentation_tpu_torch.train import loop as tloop
from pointcloudsegmentation_tpu_torch.train import model_zoo as tzoo
from test_torch_archs import assert_close
from test_torch_model import random_params

torch.set_num_threads(1)
N, CAPS = 1024, (1024, 256)


def _t(a):
    return torch.from_numpy(np.array(a))


def _block(seed, n=N, n_pad=24):
    rng = np.random.RandomState(seed)
    b = toy.synthetic_room_block(rng, n=n, num_classes=13, feat_dim=12)
    mask = np.ones(n, bool)
    mask[rng.choice(n, n_pad, replace=False)] = False
    xyz = b["xyz"].copy()
    xyz[~mask] = 0.0
    return xyz, b["feats"], mask, b["labels"]


# -- class-pure segments -------------------------------------------------------

@pytest.mark.parametrize("seed,v_max,lo", [(0, 600, 0), (1, 40, 0),
                                           (2, 600, -3)])
def test_compute_segments_key2_matches_jax(seed, v_max, lo):
    """Random keys with many repeats, labels (negative ones too), a fifth
    of the points masked, and a cap that overflows (v_max 40)."""
    rng = np.random.RandomState(seed)
    key = rng.randint(0, 300, 2000).astype(np.int32)
    key2 = rng.randint(lo, 13, 2000).astype(np.int32)
    mask = rng.rand(2000) > 0.2
    want = np.array(jvox.compute_segments(key, mask, v_max, key2=key2))
    got = tvox.compute_segments(_t(key), _t(mask), v_max, key2=_t(key2))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    got = got.numpy()
    assert (got[~mask] == v_max).all()
    kept = got < v_max
    # one segment per (key, label) pair, numbered in (key, label) order
    pairs = {(k, l): s for k, l, s in zip(key[kept], key2[kept], got[kept])}
    assert len(pairs) == len(set(got[kept]))
    ordered = [pairs[p] for p in sorted(pairs)]
    assert ordered == sorted(ordered)
    if v_max == 40:
        assert (got[mask] == v_max).any()
    # without key2: the plain segments, the same as before
    np.testing.assert_array_equal(
        tvox.compute_segments(_t(key), _t(mask), v_max).numpy(),
        np.array(jvox.compute_segments(key, mask, v_max)))


@pytest.mark.parametrize("cap", [256, 24])
def test_voxelize_with_labels_matches_jax(cap):
    """0.75 m voxels of a room block whose voxels hold several classes:
    the class-pure segments, counts and mask exactly, the centers to
    1e-6."""
    xyz, _, mask, labels = _block(3)
    plain = tvox.voxelize(_t(xyz), _t(mask), 0.75, 3.0, 256).seg.numpy()
    shared = [v for v in np.unique(plain[mask])
              if len(np.unique(labels[mask & (plain == v)])) > 1]
    assert len(shared) > 5
    want = jvox.voxelize_with_labels(xyz, mask, labels, 0.75, 3.0, cap, 13)
    got = tvox.voxelize_with_labels(_t(xyz), _t(mask), _t(labels), 0.75,
                                    3.0, cap)
    np.testing.assert_array_equal(got.seg.numpy(), np.array(want.seg))
    np.testing.assert_array_equal(got.counts.numpy(), np.array(want.counts))
    np.testing.assert_array_equal(got.mask.numpy(), np.array(want.mask))
    np.testing.assert_allclose(got.centers.numpy(), np.array(want.centers),
                               atol=1e-6, rtol=0)
    seg = got.seg.numpy()
    for v in np.unique(seg[seg < cap]):
        assert len(np.unique(labels[seg == v])) == 1
    assert (seg[~mask] == cap).all()


def test_build_class_pyramid_matches_jax():
    """On a Morton-sorted block: the two levels, segments and dxyz
    against JAX, ``morton_sorted`` carried, and level 1 in voxel-key
    order (what the windowed search's ``level_sorted(1)`` relies on)."""
    xyz, feats, mask, labels = _block(4)
    xs, ms, order, _ = (np.array(a) for a in jmorton.sort_block(
        xyz, mask, 0.0375, 3.0, feats))
    ls = labels[order]
    want = jhier.build_class_pyramid(xs, ms, ls, 13, 0.75, 256, 3.0,
                                     morton_sorted=True)
    got = thier.build_class_pyramid(_t(xs), _t(ms), _t(ls), 0.75, 256, 3.0,
                                    morton_sorted=True)
    assert got.morton_sorted and got.level_sorted(0)
    assert len(got.levels) == 2 and len(got.seg) == len(got.dxyz) == 1
    np.testing.assert_array_equal(got.seg[0].numpy(), np.array(want.seg[0]))
    for g, w in zip(got.levels, want.levels):
        np.testing.assert_array_equal(g.mask.numpy(), np.array(w.mask))
        np.testing.assert_allclose(g.xyz.numpy(), np.array(w.xyz),
                                   atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.dxyz[0].numpy(), np.array(want.dxyz[0]),
                               atol=1e-6, rtol=0)
    assert (got.dxyz[0].numpy()[~ms] == 0).all()
    # level 1 comes in voxel-key order: the keys of its members ascend
    coords, grid = tvox.voxel_coords(_t(xs), 0.75, 3.0, _t(ms))
    keys = tvox.pack_keys(coords, grid).numpy()
    seg = got.seg[0].numpy()
    first = [keys[seg == v].min() for v in range(int(got.levels[1].mask
                                                     .sum()))]
    assert first == sorted(first)


# -- refine_s3dis at full width ------------------------------------------------

def _cfgs(**over):
    over = dict(model="refine_s3dis", data_num_points=N, data_caps=CAPS,
                **over)
    return (jconfig.s3dis_config(**over),
            tconfig.s3dis_config(**dict(over, compute_dtype="float32")))


def _loss_terms(out, labels, mask, cw):
    return (jseg_loss(out[0], labels, mask, cw, None)[0]
            + jseg_loss(out[1], labels, mask, cw, None)[0])


@pytest.fixture(scope="module")
def case():
    """The JAX cascade at full width with random weights on one block: its
    [2, N, C] logits, every module's output, and the value and grad of the
    ``train=False`` loss refine + base."""
    jcfg, tcfg = _cfgs()
    jmodel = jzoo.build_model(jcfg)
    xyz, feats, mask, labels = _block(5)
    params = random_params(jmodel, xyz, feats, mask, seed=5)
    logits, inter = jax.jit(lambda p: jmodel.apply(
        p, xyz, feats, mask, False, capture_intermediates=True,
        mutable=["intermediates"]))(params)
    cw = np.asarray(jcfg.data.class_weights, np.float32)
    loss, grads = jax.jit(jax.value_and_grad(lambda p: _loss_terms(
        jmodel.apply(p, xyz, feats, mask, False), labels, mask, cw)))(params)
    return dict(params=params, block=(xyz, feats, mask), labels=labels,
                logits=np.array(logits), inter=inter["intermediates"],
                loss=float(loss), grads=np.array(ravel_pytree(grads)[0]),
                jcfg=jcfg, cfg=tcfg)


def _port(case):
    tmodel = tzoo.build_model(case["cfg"], device="cpu")
    load_flax_params(tmodel, case["params"])
    return tmodel


def test_refine_widths():
    """The full cascade at S3DIS's 12 features: the base ECD net's
    decoder, the refine net's 1600 global and 560 local columns, and the
    two unfactored heads they size."""
    model = tzoo.build_model(tconfig.s3dis_config(model="refine_s3dis"),
                             None, "cpu")
    enc = model.encoder
    assert isinstance(enc, tecd.ECDSegModel) and len(enc.specs) == 2
    assert isinstance(model.refine, ttemplate.SemanticPoolRefine)
    assert (model.refine.global_width, model.refine.local_width) == (1600,
                                                                     560)
    assert model.head.class_mlp1.in_features == enc.out_width
    assert model.refine_head.class_mlp1.in_features == 1600 + enc.out_width
    assert model.refine_head.class_mlp2.in_features == \
        512 + enc.stage0_width + 560
    assert model.refine_cap == 1024


def test_refine_layer_by_layer(case):
    """Every module of the base encoder, both heads and the refine net
    against the flax module of the same path (forward hooks against
    ``capture_intermediates``)."""
    tmodel = _port(case)
    outs = {}
    for root in ("encoder", "head", "refine", "refine_head"):
        for name, mod in getattr(tmodel, root).named_modules(prefix=root):
            mod.register_forward_hook(
                lambda m, a, out, name=name: outs.setdefault(name, out))
    with torch.no_grad():
        tmodel(*(_t(a) for a in case["block"]))
    assert "refine.stage1.gc_3.fc_out" in outs
    assert "refine.semantic_embed" in outs
    assert "refine_head.class_mlp1" in outs
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


def test_refine_end_to_end(case):
    """Both rows, permuted back to the caller's point order (axis 1)."""
    tmodel = _port(case)
    with torch.no_grad():
        got = tmodel(*(_t(a) for a in case["block"])).numpy()
    assert got.shape == (2, N, 13) and np.isfinite(got).all()
    for row in (0, 1):
        assert_close(got[row], case["logits"][row], f"row {row}")
    assert not np.allclose(got[0], got[1])


def test_refine_grads_match_jax(case):
    """The ``train=False`` loss refine + base and every parameter's
    gradient against ``jax.grad``, to 1e-4: the base encoder takes the
    refine head's gradient through [rgf ‖ gf] and [lf ‖ rlf] but none
    through the refine net's (detached) input."""
    jcfg, tcfg = case["jcfg"], case["cfg"]
    opt = optax.adam(jschedule(jcfg)).init(ravel_pytree(case["params"])[0])
    trainer = tloop.Trainer(tcfg, device="cpu")
    state = trainer.init_state(state=flax_train_state_to_torch(
        JState(step=np.int32(0), params=case["params"], opt_state=opt),
        trainer.model))
    xyz, feats, mask = case["block"]
    batch = {"xyz": xyz[None], "feats": feats[None], "mask": mask[None],
             "labels": case["labels"][None]}
    loss, grad = trainer.loss_and_grad(state, batch, train=False)
    np.testing.assert_allclose(float(loss), case["loss"], rtol=1e-4)
    want = case["grads"]
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(grad.numpy(), want, rtol=1e-4, atol=1e-4)
    for leaf in trainer.layout:
        if leaf.key.startswith(("encoder.", "refine.")):
            assert leaf.view(grad).abs().max() > 0, leaf.key


def test_refine_input_is_detached(case, monkeypatch):
    """The refine net's semantic input is the base global features
    detached, in a forward that records gradients."""
    tmodel = _port(case)
    seen = {}
    real = tmodel.refine.forward

    def spy(pyr, sem):
        seen["requires_grad"] = sem.requires_grad
        return real(pyr, sem)

    monkeypatch.setattr(tmodel.refine, "forward", spy)
    xyz, feats, mask = (_t(a) for a in case["block"])
    tmodel(xyz, feats, mask)
    assert seen == {"requires_grad": False}


def test_eval_scene_probs_takes_the_refine_row(case):
    tmodel = _port(case)
    xyz, feats, mask = case["block"]
    _, probs = eval_scene_probs(tmodel, [dict(xyz=xyz, feats=feats,
                                              mask=mask)])
    want = np.array(jax.nn.softmax(case["logits"][0], -1))[mask]
    np.testing.assert_allclose(probs, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(probs.sum(1), 1.0, atol=1e-5)


# -- a narrow cascade through the trainers ---------------------------------------

NARROW_BASE = (
    jecd.ECDStageSpec(radius=0.15, k=16, gxyz_dim=4, gc_dims=(4,),
                      gfc_dims=(4,), final_dim=8, dxyz_scale=0.075),
    jecd.ECDStageSpec(radius=0.3, k=16, gxyz_dim=4, gc_dims=(4, 8),
                      gfc_dims=(8,), final_dim=8, dxyz_scale=0.225),
)
NARROW_REFINE = (
    jecd.ECDStageSpec(radius=0.1, k=16, gxyz_dim=4, gc_dims=(4,),
                      gfc_dims=(8,), final_dim=8, dxyz_scale=0.2),
    jecd.ECDStageSpec(radius=1.5, k=16, gxyz_dim=4, gc_dims=(8,),
                      gfc_dims=(8,), final_dim=8, dxyz_scale=3.0),
)


def _torch_spec(specs):
    return tuple(tecd.ECDStageSpec(**vars(sp)) for sp in specs)


@pytest.fixture
def narrow(monkeypatch):
    """Both registries' cascades with narrow base and refine stages."""
    monkeypatch.setattr(jzoo, "S3DIS_ECD_SPEC", NARROW_BASE)
    monkeypatch.setattr(jmodels, "SemanticPoolRefine", functools.partial(
        jmodels.SemanticPoolRefine, stage0=NARROW_REFINE[0],
        stage1=NARROW_REFINE[1]))
    monkeypatch.setitem(tzoo._CASCADES, "refine_s3dis", functools.partial(
        tecd.ECDSegModel, specs=_torch_spec(NARROW_BASE)))
    monkeypatch.setattr(ttemplate, "REFINE_SPECS",
                        _torch_spec(NARROW_REFINE))


def test_trainer_step_matches_jax(narrow, monkeypatch):
    """One ``train_step`` of the narrow cascade on 2 blocks, dropout off on
    both sides: the loss (refine + 1.0 * base, weights counted once) to
    rel 1e-4, the refine row's confusion matrix and counts equal, the
    accumulated gradient (Adam's first moment after one step from zero) to
    1e-4."""
    jcfg, tcfg = _cfgs(compute_dtype="float32")
    batch = next(toy.toy_batches(1, batch_size=2, num_points=N,
                                 kind="room", num_classes=13, feat_dim=12))
    batch["mask"][1, -40:] = False
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        jtrainer = JTrainer(jcfg)
        params = random_params(jtrainer.model, batch["xyz"][0],
                               batch["feats"][0], batch["mask"][0], seed=6)
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
    assert int(m["count"]) == int(jm["count"]) == int(batch["mask"].sum())
    assert int(m["correct"]) == int(jm["correct"])
    want = flax_train_state_to_torch(state1, trainer.model)
    assert want.mu.abs().max() > 1e-3
    np.testing.assert_allclose(state.mu.numpy(), want.mu.numpy(),
                               rtol=1e-4, atol=1e-5)
    assert tloop.BASE_LOSS_WEIGHT == 1.0


def test_cli_trains_refine_and_restores(narrow, tmp_path):
    """The train CLI on the CPU: one step of the narrow cascade with its
    test epoch and a checkpoint, ``--restore --eval`` giving the epoch's
    test metrics bit for bit, then the scene eval labelling a synthetic
    scene from that checkpoint with the refine row."""
    ck = tmp_path / "ck"
    base = ["--config", "s3dis", "--synthetic", "--model", "refine_s3dis",
            "--steps-per-epoch", "1", "--batch-size", "1", "--num-points",
            str(N), "--device", "cpu", "--checkpoint-dir", str(ck)]
    cli.main(base + ["--epochs", "1", "--metrics-file",
                     str(tmp_path / "t.jsonl")])
    rec, = [json.loads(line) for line in open(tmp_path / "t.jsonl")]
    assert np.isfinite(rec["train_loss"])
    cli.main(base + ["--restore", "--eval", "--metrics-file",
                     str(tmp_path / "e.jsonl")])
    ev, = [json.loads(line) for line in open(tmp_path / "e.jsonl")]
    for key in ("miou", "oiou", "oacc", "iou", "acc"):
        assert ev[key] == rec[key], key
    out = interpolate.main(["--config", "s3dis", "--model", "refine_s3dis",
                            "--synthetic", "--num-points", str(N),
                            "--checkpoint-dir", str(ck), "--out-dir",
                            str(tmp_path / "out"), "--device", "cpu"])
    r, = out
    assert r["probs"].shape[1] == 13
    np.testing.assert_allclose(r["probs"].sum(1), 1.0, atol=1e-5)
