"""The template harness of the port against the JAX package, float32,
``train=False``, JAX weights converted by ``convert.py``: ``GenericStage``
with each of its four convs on a sorted 1024-point block (windowed search
with per-point overflow slots), the four ``template_*`` keys at full
width layer by layer and end to end (caps (1024, 256): levels 0 and 1
windowed, level 2 global), ``template_anchor``'s gradient (its trainable
anchors included) against ``jax.grad``, the anchors' init, the
``*_anchor`` leaves through ``ravel_layout``, every composite key's
parameter count, and ``chip_smoke``'s gather counts against the gathers
a bf16 forward and backward really make.  Floats hold 1e-4 after dividing
by max(1, the largest |JAX output|) (``assert_close``)."""
import functools

import jax
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

from pointcloudsegmentation_tpu.data import toy
from pointcloudsegmentation_tpu.models import template as jtemplate
from pointcloudsegmentation_tpu.ops import anchors as janchors
from pointcloudsegmentation_tpu.ops import morton as jmorton
from pointcloudsegmentation_tpu.train import config as jconfig
from pointcloudsegmentation_tpu.train import model_zoo as jzoo
from pointcloudsegmentation_tpu.train.loop import TrainState as JState
from pointcloudsegmentation_tpu.train.loop import \
    make_lr_schedule as jschedule
from pointcloudsegmentation_tpu.train.loop import seg_loss as jseg_loss
from pointcloudsegmentation_tpu_torch import config as tconfig
from pointcloudsegmentation_tpu_torch.convert import (
    flax_to_state_dict, flax_train_state_to_torch, load_flax_params,
    ravel_layout)
from pointcloudsegmentation_tpu_torch.kernels import window_gather as wg
from pointcloudsegmentation_tpu_torch.models import ecd as tecd
from pointcloudsegmentation_tpu_torch.models import template as ttemplate
from pointcloudsegmentation_tpu_torch.train import model_zoo as tzoo
from pointcloudsegmentation_tpu_torch.train.loop import Trainer
from test_torch_archs import assert_close
from test_torch_gpn import _chip_smoke
from test_torch_model import random_params, random_tree

torch.set_num_threads(1)
N, CAPS = 1024, (1024, 256)
CONVS = ("pointnet", "anchor", "mlp_anchor", "diffusion_anchor")
TEMPLATE_KEYS = tuple(f"template_{c}" for c in CONVS)
# the JAX registry's parameter counts at S3DIS's 12 features
PARAMS = {"refine_s3dis": 3492194, "template_pointnet": 1258777,
          "template_anchor": 1282713, "template_mlp_anchor": 1291225,
          "template_diffusion_anchor": 1253769}

_JAX_KMEANS = janchors.sphere_kmeans_anchors


@pytest.fixture(scope="module", autouse=True)
def jax_anchors_once():
    """The JAX anchor conv reruns its anchors' k-means at every trace; for
    this module's duration it reads one result per m."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(janchors, "sphere_kmeans_anchors",
                   functools.lru_cache(maxsize=None)(_JAX_KMEANS))
        yield


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


def _cfgs(key, **over):
    over = dict(model=key, data_num_points=N, data_caps=CAPS, **over)
    return (jconfig.s3dis_config(**over),
            tconfig.s3dis_config(**dict(over, compute_dtype="float32")))


@pytest.mark.parametrize("key", sorted(PARAMS))
def test_param_counts_match_jax(key):
    jcfg = jconfig.s3dis_config(model=key)
    shapes = jax.eval_shape(lambda: jzoo.build_model(jcfg).init(
        jax.random.PRNGKey(0), np.zeros((N, 3), np.float32),
        np.zeros((N, 12), np.float32), np.ones(N, bool), False))
    jn = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    model = tzoo.build_model(tconfig.s3dis_config(model=key), None, "cpu")
    assert sum(p.numel() for p in model.parameters()) == jn == PARAMS[key]


# -- one stage of each conv ------------------------------------------------------

@pytest.fixture(scope="module")
def sorted_block():
    xyz, feats, mask, _ = _block(9)
    xyz, mask, _, feats = (np.array(a) for a in jmorton.sort_block(
        xyz, mask, 0.0375, 3.0, feats))
    return xyz, mask, (xyz * 0.5).astype(np.float32), feats


@pytest.mark.parametrize("conv", CONVS)
def test_generic_stage_matches_jax(sorted_block, conv):
    """Stage 0 of the template (radius 0.15, 16 slots + 8 overflow, xyz
    conv 16 wide, one 16-wide gc conv) on the sorted block: (fc_final,
    cfeats)."""
    spec = ttemplate.TEMPLATE_SPECS[0]
    jspec = jtemplate.TemplateSegModel.specs[0]
    assert vars(jspec) == vars(spec)
    jmod = jtemplate.GenericStage(jspec, conv=conv)
    tmod = ttemplate.GenericStage(spec, 12, conv)
    params = random_tree(jax.eval_shape(lambda: jmod.init(
        jax.random.PRNGKey(0), *sorted_block, is_sorted=True)), 13)
    want = jax.jit(lambda p: jmod.apply(p, *sorted_block,
                                        is_sorted=True))(params)
    tmod.load_state_dict(flax_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = tmod(*(_t(a) for a in sorted_block), is_sorted=True)
    assert tmod.lf_width == 16 + 12 + 16
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        assert_close(g.numpy(), np.array(w))


def test_anchor_init_is_the_sphere_kmeans():
    """A seeded build leaves each trainable anchor at the JAX init's value,
    ``sphere_kmeans_anchors(16).T`` (a JAX ``GenericStage`` init on a
    small block), and draws every Dense."""
    jmod = jtemplate.GenericStage(jtemplate.TemplateSegModel.specs[0],
                                  conv="anchor")
    xyz, feats, mask, _ = _block(2, n=256, n_pad=0)
    jp = jmod.init(jax.random.PRNGKey(0), xyz, mask, xyz, feats)["params"]
    model = tzoo.build_model(tconfig.s3dis_config(model="template_anchor"),
                             torch.Generator().manual_seed(0), "cpu")
    anchors = {k: v for k, v in model.state_dict().items()
               if k.endswith("_anchor")}
    assert len(anchors) == 6
    for key, value in anchors.items():
        assert value.shape == (16, 3)
        np.testing.assert_array_equal(value.numpy(),
                                      np.array(jp["xyz_gc_anchor"]), key)
    np.testing.assert_array_equal(np.array(jp["gc_0_anchor"]),
                                  _JAX_KMEANS(16).T)
    fc = model.encoder.stage0.xyz_gc_fc_out.weight
    assert fc.shape == (16, 16 * 3) and fc.abs().max() > 0


# -- the four template keys at full width ----------------------------------------

class Cases:
    """Module-scoped cache of the JAX template models' outputs."""

    def __init__(self):
        self.done = {}

    def __call__(self, key):
        if key not in self.done:
            seed = 50 + TEMPLATE_KEYS.index(key)
            jcfg, tcfg = _cfgs(key)
            jmodel = jzoo.build_model(jcfg)
            xyz, feats, mask, labels = _block(seed)
            params = random_params(jmodel, xyz, feats, mask, seed=seed)
            logits, inter = jax.jit(lambda p: jmodel.apply(
                p, xyz, feats, mask, False, capture_intermediates=True,
                mutable=["intermediates"]))(params)
            self.done[key] = dict(
                params=params, block=(xyz, feats, mask), labels=labels,
                logits=np.array(logits), inter=inter["intermediates"],
                jcfg=jcfg, cfg=tcfg, jmodel=jmodel)
        return self.done[key]


@pytest.fixture(scope="module")
def cases():
    return Cases()


def _port(case):
    tmodel = tzoo.build_model(case["cfg"], device="cpu")
    load_flax_params(tmodel, case["params"])
    return tmodel


@pytest.mark.parametrize("key", TEMPLATE_KEYS)
def test_template_layer_by_layer_and_end_to_end(cases, key):
    """Every module of the port's encoder and head against the flax module
    of the same path (forward hooks against ``capture_intermediates``),
    then the logits."""
    case = cases(key)
    tmodel = _port(case)
    enc = tmodel.encoder
    assert isinstance(enc, ttemplate.TemplateSegModel) and enc.head_dim is None
    assert not tmodel.head.premixed
    assert tmodel.head.class_mlp1.in_features == enc.out_width
    outs = {}
    for root in ("encoder", "head"):
        for name, mod in getattr(tmodel, root).named_modules(prefix=root):
            mod.register_forward_hook(
                lambda m, a, out, name=name: outs.setdefault(name, out))
    with torch.no_grad():
        got = tmodel(*(_t(a) for a in case["block"])).numpy()
    assert "encoder.stage2.final_gfc" in outs and "head.class_mlp3" in outs
    for name, out in outs.items():
        node = case["inter"]
        for part in name.split("."):
            node = node[part]
        want = node["__call__"][0]
        g = out if isinstance(out, tuple) else (out,)
        w = want if isinstance(want, tuple) else (want,)
        assert len(g) == len(w), name
        for a, b in zip(g, w):
            assert a.shape == b.shape, (name, a.shape, b.shape)
            assert_close(a.numpy(), np.array(b), name)
    assert got.shape == (N, 13) and np.isfinite(got).all()
    assert_close(got, case["logits"])


def test_template_anchor_grads_match_jax(cases):
    """The ``train=False`` loss and every parameter's gradient of
    ``template_anchor``, its six trainable anchors' included, against
    ``jax.grad``, to 1e-4."""
    case = cases("template_anchor")
    jmodel, params = case["jmodel"], case["params"]
    xyz, feats, mask = case["block"]
    cw = np.asarray(case["jcfg"].data.class_weights, np.float32)
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jseg_loss(
        jmodel.apply(p, xyz, feats, mask, False), case["labels"], mask, cw,
        None)[0]))(params)
    opt = optax.adam(jschedule(case["jcfg"])).init(ravel_pytree(params)[0])
    trainer = Trainer(case["cfg"], device="cpu")
    state = trainer.init_state(state=flax_train_state_to_torch(
        JState(step=np.int32(0), params=params, opt_state=opt),
        trainer.model))
    batch = {"xyz": xyz[None], "feats": feats[None], "mask": mask[None],
             "labels": case["labels"][None]}
    tloss, grad = trainer.loss_and_grad(state, batch, train=False)
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-4)
    want = np.array(ravel_pytree(grads)[0])
    np.testing.assert_allclose(grad.numpy(), want, rtol=1e-4, atol=1e-4)
    anchors = [leaf for leaf in trainer.layout
               if leaf.path[-1].endswith("_anchor")]
    assert len(anchors) == 6
    for leaf in anchors:
        assert leaf.view(grad).abs().max() > 0, leaf.key


def test_anchor_leaves_load_through_ravel_layout(cases):
    """A JAX train state of ``template_anchor`` (its ``xyz_gc_anchor`` and
    ``gc_0_anchor`` leaves, no transpose) loads: ``ravel_layout`` is
    ``ravel_pytree``'s order, the Adam moments copy over, and
    ``load_flax_params`` puts each anchor in place."""
    case = cases("template_anchor")
    params = case["params"]
    vec = ravel_pytree(params)[0]
    rng = np.random.RandomState(7)
    mu = rng.randn(vec.size).astype(np.float32)
    nu = rng.rand(vec.size).astype(np.float32)
    opt = optax.adam(jschedule(case["jcfg"])).init(vec)
    opt = (opt[0]._replace(count=np.int32(4), mu=mu, nu=nu),
           opt[1]._replace(count=np.int32(4)))
    model = _port(case)
    layout = ravel_layout(model)
    assert [leaf.path for leaf in layout] == [
        tuple(k.key for k in p)[1:]
        for p, _ in jax.tree_util.tree_leaves_with_path(params)]
    st = flax_train_state_to_torch(
        JState(step=np.int32(4), params=params, opt_state=opt), model)
    np.testing.assert_array_equal(st.params.numpy(), np.array(vec))
    np.testing.assert_array_equal(st.nu.numpy(), nu)
    leaf = next(leaf for leaf in layout
                if leaf.path == ("encoder", "stage1", "gc_0_anchor"))
    want = np.array(params["params"]["encoder"]["stage1"]["gc_0_anchor"])
    np.testing.assert_array_equal(leaf.view(st.params).numpy(), want)
    np.testing.assert_array_equal(
        model.encoder.stage1.gc_0_anchor.detach().numpy(), want)


# -- chip_smoke's launch counts ----------------------------------------------------

@pytest.mark.parametrize("key", TEMPLATE_KEYS + ("refine_s3dis",))
def test_chip_smoke_counts_every_gather(key, monkeypatch):
    """``chip_smoke.composite_gathers``, which phase 13 holds the card's
    launch counts to, names every windowed gather a bf16 forward of the key
    makes, in order, with its rows, slots, width and dtype, and flags as
    trained exactly the gathers whose backward runs the slab-gradient
    sums (recorded from the plain versions on the CPU at 1024 points)."""
    cs = _chip_smoke()
    cfg = tconfig.s3dis_config(model=key, data_num_points=N, data_caps=CAPS)
    model = tzoo.build_model(cfg, torch.Generator().manual_seed(0), "cpu")
    xyz, feats, mask, _ = _block(5)
    seen, sums = [], []
    plain_fwd, plain_bwd = wg.gather_fwd_reference, wg.dslab_bwd_reference

    def record(f, lidx, window, tile):
        seen.append((f.shape[0], lidx.shape[1], f.shape[1], f.dtype))
        return plain_fwd(f, lidx, window, tile)

    def record_bwd(g, lidx, window, tile):
        sums.append(tuple(g.shape) + (g.dtype,))
        return plain_bwd(g, lidx, window, tile)

    monkeypatch.setattr(wg, "gather_fwd_reference", record)
    monkeypatch.setattr(wg, "dslab_bwd_reference", record_bwd)
    out = model(_t(xyz), _t(feats), _t(mask))
    out.float().square().mean().backward()
    gathers = cs.composite_gathers(model, cfg)
    assert seen == [(n, k, f, dt) for _, n, k, f, dt, _ in gathers]
    trained = [(n, k, f, dt) for _, n, k, f, dt, grad in gathers if grad]
    assert sorted(sums, key=str) == sorted(trained, key=str)
    fwd, step = cs.gathers_per_block(cfg, cs.composite_gathers)
    assert fwd == {"window_gather": len(seen)}
    assert step["window_dslab"] == step["window_dslab_map"] == len(sums)
    if key == "refine_s3dis":
        assert isinstance(model.encoder, tecd.ECDSegModel)
        assert [g[0] for g in gathers if g[0].startswith("refine")] == [
            "refine search", "refine.stage0.gc_0", "refine.stage0.gc_1"]
    else:
        xyz_rows = {g[4] for g in gathers if g[0].endswith("xyz_gc")}
        assert xyz_rows == ({torch.float32} if key in (
            "template_anchor", "template_mlp_anchor") else {torch.bfloat16})
