"""The GPN family of the port against the JAX package, float32,
``train=False``, JAX weights converted by ``convert.py``: the anchor
generators bit for bit; ``GPNConv`` in both modes ``GPNStage`` builds
(flattened per anchor), with its own and with shared location weights,
and its gradient against ``jax.grad``; ``DiffusionAnchorConv`` v1-v3 on
a windowed neighborhood with per-point overflow slots and on a global
one; a narrow ``GPNStage`` on both; then a
narrow ``gpn_seg`` at 1024 points (caps (1024, 256): levels 0 and 1
windowed, level 2 global) layer by layer, end to end, its loss and flat
gradient, its flat layout and Adam moments, the init that draws every
``pw``, and ``chip_smoke.gpn_gathers`` against the gathers a bf16 forward
really makes.  Every comparison divides by max(1, the largest |JAX
output|) and holds 1e-4 (``assert_close``).

The registry's full-width specs compile slowly on the CPU, so the models
here are built from ``NARROW`` (m = 4 anchors, 2-wide growth) by patching
both registries' GPN encoders for the test's duration; the card runs the
full width (``chip_smoke.py`` phase 12)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

from pointcloudsegmentation_tpu.data import toy
from pointcloudsegmentation_tpu.models import gpn as jgpn
from pointcloudsegmentation_tpu.models import layers as jlayers
from pointcloudsegmentation_tpu.models import variants as jvariants
from pointcloudsegmentation_tpu.ops import anchors as janchors
from pointcloudsegmentation_tpu.ops import morton as jmorton
from pointcloudsegmentation_tpu.ops import search as jsearch
from pointcloudsegmentation_tpu.train import config as jconfig
from pointcloudsegmentation_tpu.train import model_zoo as jzoo
from pointcloudsegmentation_tpu.train.loop import TrainState as JState
from pointcloudsegmentation_tpu.train.loop import \
    make_lr_schedule as jschedule
from pointcloudsegmentation_tpu.train.loop import seg_loss as jseg_loss
from pointcloudsegmentation_tpu_torch import config as tconfig
from pointcloudsegmentation_tpu_torch.convert import (
    flax_to_state_dict, flax_train_state_to_torch, load_flax_params,
    ravel_layout, ravel_params)
from pointcloudsegmentation_tpu_torch.models import gpn as tgpn
from pointcloudsegmentation_tpu_torch.models import layers as tlayers
from pointcloudsegmentation_tpu_torch.models import variants as tvariants
from pointcloudsegmentation_tpu_torch.ops import anchors as tanchors
from pointcloudsegmentation_tpu_torch.ops.types import (Neighborhood,
                                                        WindowedNeighborhood)
from pointcloudsegmentation_tpu_torch.train import model_zoo as tzoo
from pointcloudsegmentation_tpu_torch.train.loop import Trainer
from test_torch_archs import assert_close
from test_torch_ecd import round_trip
from test_torch_model import random_params, random_tree

torch.set_num_threads(1)
N, CAPS, M = 1024, (1024, 256), 4

# three stages, so that level 2 (256 points) takes the global search and
# the top stage conditions on the level's xyz, as the full spec does
NARROW = (
    jgpn.GPNStageSpec(radius=0.15, k=16, gxyz_dim=4, gc_dims=(4, 4),
                      fc_dims=(4, 4), gfc_dims=(8,), final_dim=8),
    jgpn.GPNStageSpec(radius=0.45, k=16, gxyz_dim=4, gc_dims=(4, 8),
                      fc_dims=(4, 8), gfc_dims=(8, 8), final_dim=8),
    jgpn.GPNStageSpec(radius=0.9, k=8, gxyz_dim=4, gc_dims=(8,),
                      fc_dims=(8,), gfc_dims=(8,), final_dim=16),
)
T_NARROW = tuple(tgpn.GPNStageSpec(**vars(sp)) for sp in NARROW)


def _t(a):
    return torch.from_numpy(np.array(a))


_JAX_KMEANS = janchors.sphere_kmeans_anchors


@pytest.fixture(scope="module", autouse=True)
def jax_anchors_once():
    """The JAX layers rerun the anchors' k-means at every trace (0.4 s at
    m = 4); for this module's duration they read one result per m."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(janchors, "sphere_kmeans_anchors",
                   functools.lru_cache(maxsize=None)(_JAX_KMEANS))
        yield


@pytest.fixture(scope="module")
def narrow():
    """Both registries' GPN encoders at NARROW width while the module's
    tests run."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgpn, "GPNSegModel",
                   functools.partial(jgpn.GPNSegModel, specs=NARROW, m=M))
        mp.setattr(jzoo, "GPNClassModel",
                   functools.partial(jgpn.GPNClassModel, specs=NARROW, m=M))
        mp.setitem(tzoo._ENCODERS, "gpn_seg", functools.partial(
            tgpn.GPNSegModel, specs=T_NARROW, m=M))
        mp.setitem(tzoo._CLASSIFIERS, "gpn_modelnet40", functools.partial(
            tgpn.GPNClassModel, specs=T_NARROW, m=M))
        yield


# -- anchors -----------------------------------------------------------------

@pytest.mark.parametrize("m", [4, 8, 26])
def test_sphere_kmeans_anchors_bitwise(m):
    want = _JAX_KMEANS(m)
    got = tanchors.sphere_kmeans_anchors(m)
    assert got.dtype == want.dtype == np.float32 and got.shape == (3, m)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tanchors.cached_sphere_anchors(m), want)
    # canonicalised: anchor 0 (a cluster mean, inside the sphere) lies on +z
    np.testing.assert_allclose(got[:2, 0], 0, atol=1e-6)
    assert got[2, 0] > 0


@pytest.mark.parametrize("name,m", [("grid_anchors_v2", 26),
                                    ("grid_anchors", 40)])
def test_grid_anchors_bitwise(name, m):
    want = getattr(janchors, name)()
    got = getattr(tanchors, name)()
    assert got.shape == (3, m) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_cached_anchors_are_a_copy():
    a = tanchors.cached_sphere_anchors(4)
    a[:] = 0
    assert tanchors.cached_sphere_anchors(4).any()


# -- single layers on both neighborhood kinds --------------------------------

@pytest.fixture(scope="module")
def nbrs():
    """A sorted 1024-point toy block with 40 padded points: the JAX
    windowed neighborhood (band (0, 0.15, 16), pool 64, per-point
    overflow) and the global one (the same band), each with the port's
    copy and the raw sxyz; 12-wide features."""
    rng = np.random.RandomState(9)
    b = toy.synthetic_room_block(rng, n=N)
    mask = np.ones(N, bool)
    mask[rng.choice(N, 40, replace=False)] = False
    xyz = b["xyz"].copy()
    xyz[~mask] = 0.0
    xyz, mask, _, feats = (np.array(a) for a in jmorton.sort_block(
        xyz, mask, 0.0375, 3.0, b["feats"]))
    (jw, wsx), = jsearch.windowed_multi_band_neighbors(
        xyz, mask, ((0.0, 0.15, 16),), tile=256, window=256, cand_k=64,
        ov_slots=8, chunk=1024, return_sxyz=True, ov_pool_size=0,
        sel_mode="slab")
    assert np.array(jw.ov_mask).any()
    tw = WindowedNeighborhood(
        lidx=_t(jw.lidx), wmask=_t(jw.wmask), ov_idx=_t(jw.ov_idx),
        ov_mask=_t(jw.ov_mask), window=256, tile=256)
    (jg, gsx), = jsearch.multi_band_neighbors(
        xyz, mask, ((0.0, 0.15, 16),), cand_k=64, chunk=1024,
        return_sxyz=True)
    tg = Neighborhood(idx=_t(jg.idx), mask=_t(jg.mask))
    return {"windowed": (jw, tw, np.array(wsx)),
            "global": (jg, tg, np.array(gsx)),
            "feats": feats, "xyz": xyz, "mask": mask}


def _flax_params(jmod, args, kwargs, seed):
    return random_tree(jax.eval_shape(lambda: jmod.init(
        jax.random.PRNGKey(0), *args, **kwargs)), seed)


def _compare(jmod, tmod, args, targs, seed, kwargs=None, tkwargs=None):
    """Random flax weights for ``jmod`` loaded into ``tmod`` (strict); every
    output against the flax module's.  Returns (params, outputs)."""
    kwargs, tkwargs = kwargs or {}, tkwargs or {}
    params = _flax_params(jmod, args, kwargs, seed)
    want = jmod.apply(params, *args, **kwargs)
    tmod.load_state_dict(flax_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = tmod(*targs, **tkwargs)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        assert_close(g.numpy(), np.array(w))
    return params, got


KINDS = ["windowed", "global"]


def _args(nbrs, kind, feats=True):
    jn, tn, sxyz = nbrs[kind]
    f = nbrs["feats"] if feats else None
    return ((sxyz, f, jn), (_t(sxyz), None if f is None else _t(f), tn))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode", ["xyz", "feats"])
def test_gpn_conv(nbrs, kind, mode):
    a, ta = _args(nbrs, kind, mode != "xyz")
    jmod = jlayers.GPNConv(M, 6, mode=mode, no_sum=True)
    tmod = tlayers.GPNConv(12, M, 6, mode=mode, no_sum=True)
    assert "pmiu" not in tmod.state_dict()
    np.testing.assert_array_equal(tmod.pmiu.numpy(),
                                  janchors.sphere_kmeans_anchors(M))
    _, (out, lw, lw_sum) = _compare(jmod, tmod, a, ta, seed=1)
    assert out.shape == (N, M * 6)
    # lw lives on the valid slots only
    assert not lw[~ta[2].mask].any() and (lw_sum > 0).any()


@pytest.mark.parametrize("kind", KINDS)
def test_gpn_conv_shared_lw(nbrs, kind):
    """An xyz conv that makes lw and a feats conv that takes it, as
    ``GPNStage`` chains them."""
    a, ta = _args(nbrs, kind)
    jfirst = jlayers.GPNConv(M, 4, mode="xyz", no_sum=True)
    tfirst = tlayers.GPNConv(0, M, 4, mode="xyz", no_sum=True)
    params, (_, lw, lw_sum) = _compare(jfirst, tfirst, a, ta, seed=2)
    _, jlw, jlw_sum = jfirst.apply(params, *a)
    jshared = jlayers.GPNConv(M, 5, mode="feats", no_sum=True)
    tshared = tlayers.GPNConv(12, M, 5, mode="feats", no_sum=True,
                              shared_lw=True)
    assert not hasattr(tshared, "pmiu")
    kw = dict(lw=jlw, lw_sum=jlw_sum)
    _compare(jshared, tshared, a, ta, seed=3, kwargs=kw,
             tkwargs=dict(lw=lw, lw_sum=lw_sum))
    with pytest.raises(ValueError):
        tshared(*ta)


@pytest.mark.parametrize("kind", KINDS)
def test_gpn_conv_gradient(nbrs, kind):
    """The feats conv's gradient in pw, bias and the gathered features
    (the window gather's backward on the windowed neighborhood) against
    ``jax.grad``, to 1e-4."""
    a, ta = _args(nbrs, kind)
    jmod = jlayers.GPNConv(M, 6, mode="feats", no_sum=True)
    params = _flax_params(jmod, a, {}, 4)
    w = np.random.RandomState(5).randn(N, M * 6).astype(np.float32)
    sxyz, feats, jn = a

    def loss(p, f):
        return jnp.sum(jmod.apply(p, sxyz, f, jn)[0] * w)

    gp, gf = jax.grad(loss, argnums=(0, 1))(params, feats)
    tmod = tlayers.GPNConv(12, M, 6, mode="feats", no_sum=True)
    tmod.load_state_dict(flax_to_state_dict(params), strict=True)
    tf = _t(feats).requires_grad_(True)
    (tmod(ta[0], tf, ta[2])[0] * _t(w)).sum().backward()
    for got, want in ((tmod.pw.grad, gp["params"]["pw"]),
                      (tmod.bias.grad, gp["params"]["bias"]),
                      (tf.grad, gf)):
        want = np.array(want)
        assert np.abs(want).max() > 1e-3
        assert_close(got.numpy(), want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("version", [1, 2, 3])
def test_diffusion_anchor_conv(nbrs, kind, version):
    a, ta = _args(nbrs, kind)
    ed = 0 if version == 1 else 3
    _compare(jvariants.DiffusionAnchorConv(version, 5, 8, (6, 6),
                                           embed_dim=ed),
             tvariants.DiffusionAnchorConv(12, version, 5, 8, (6, 6),
                                           embed_dim=ed), a, ta,
             seed=11 + version)


@pytest.mark.parametrize("is_sorted", [True, False])
def test_gpn_stage(nbrs, is_sorted):
    """A narrow stage on the sorted block: its own search (windowed when
    the level is asserted sorted, else global), (fc_final, cfeats)."""
    xyz, mask, feats = nbrs["xyz"], nbrs["mask"], nbrs["feats"]
    dxyz = (xyz * 0.5).astype(np.float32)
    jmod = jgpn.GPNStage(NARROW[0], M)
    tmod = tgpn.GPNStage(T_NARROW[0], 12, M)
    assert tmod.lf_width == 4 + 12 + 4 + 4
    _compare(jmod, tmod, (xyz, mask, dxyz, feats),
             tuple(_t(x) for x in (xyz, mask, dxyz, feats)), seed=15,
             kwargs=dict(is_sorted=is_sorted),
             tkwargs=dict(is_sorted=is_sorted))


# -- the narrow gpn_seg ------------------------------------------------------

def _seg_cfgs(**over):
    over = dict(model="gpn_seg", data_num_points=N, data_caps=CAPS, **over)
    return (jconfig.s3dis_config(**over),
            tconfig.s3dis_config(compute_dtype="float32", **over))


def _block(seed):
    rng = np.random.RandomState(seed)
    b = toy.synthetic_room_block(rng, n=N)
    mask = np.ones(N, bool)
    mask[rng.choice(N, 24, replace=False)] = False
    xyz = b["xyz"].copy()
    xyz[~mask] = 0.0
    return xyz, b["feats"], mask, b["labels"]


@pytest.fixture(scope="module")
def seg_case(narrow):
    jcfg, tcfg = _seg_cfgs()
    jmodel = jzoo.build_model(jcfg)
    xyz, feats, mask, labels = _block(21)
    params = random_params(jmodel, xyz, feats, mask, seed=21)
    logits, inter = jax.jit(lambda p: jmodel.apply(
        p, xyz, feats, mask, False, capture_intermediates=True,
        mutable=["intermediates"]))(params)
    cw = np.asarray(jcfg.data.class_weights, np.float32)

    def loss_fn(p):
        return jseg_loss(jmodel.apply(p, xyz, feats, mask, False), labels,
                         mask, cw, None)[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return dict(params=params, block=(xyz, feats, mask), labels=labels,
                logits=np.array(logits), inter=inter["intermediates"],
                loss=float(loss), grads=np.array(ravel_pytree(grads)[0]),
                jcfg=jcfg, cfg=tcfg, jmodel=jmodel)


def _port(case):
    tmodel = tzoo.build_model(case["cfg"], device="cpu")
    load_flax_params(tmodel, case["params"])
    return tmodel


def test_gpn_seg_widths(narrow):
    """The full spec at S3DIS's 12 features: the decoder's 1724 columns and
    stage 0's 108, which size the unfactored head."""
    enc = tgpn.GPNSegModel(12)
    assert (enc.out_width, enc.stage0_width, enc.head_dim) == (1724, 108,
                                                               None)
    model = tzoo.build_model(tconfig.s3dis_config(model="gpn_seg"),
                             device="cpu")
    assert isinstance(model.encoder, tgpn.GPNSegModel)
    assert model.encoder.specs == T_NARROW   # the patched registry
    assert model.head.class_mlp1.in_features == model.encoder.out_width


def test_gpn_seg_layer_by_layer(seg_case):
    """Every module of the port's encoder and head against the flax module
    of the same path (forward hooks against ``capture_intermediates``),
    the anchored convs' (out, lw, lw_sum) included."""
    tmodel = _port(seg_case)
    outs = {}
    for root in ("encoder", "head"):
        for name, mod in getattr(tmodel, root).named_modules(prefix=root):
            mod.register_forward_hook(
                lambda m, a, out, name=name: outs.setdefault(name, out))
    with torch.no_grad():
        tmodel(*(_t(x) for x in seg_case["block"]))
    assert "encoder.stage2.gc_0" in outs and "head.class_mlp1" in outs
    for name, out in outs.items():
        node = seg_case["inter"]
        for part in name.split("."):
            node = node[part]
        want = node["__call__"][0]
        got = out if isinstance(out, tuple) else (out,)
        want = want if isinstance(want, tuple) else (want,)
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            assert g.shape == w.shape, (name, g.shape, w.shape)
            assert_close(g.numpy(), np.array(w), name)


def test_gpn_seg_end_to_end(seg_case):
    tmodel = _port(seg_case)
    with torch.no_grad():
        got = tmodel(*(_t(x) for x in seg_case["block"])).numpy()
    assert got.shape == (N, 13) and np.isfinite(got).all()
    assert_close(got, seg_case["logits"])


def test_gpn_seg_convert_round_trip(seg_case):
    _, kinds = round_trip(seg_case)
    assert kinds == {"kernel", "bias", "pw"}


def test_gpn_seg_loss_and_grads_match_jax(seg_case):
    """The ``train=False`` loss and every parameter's gradient of the
    narrow ``gpn_seg`` (the anchored convs' pw and bias, the window
    gathers' backward) against ``jax.grad``, to 1e-4."""
    jcfg, tcfg = seg_case["jcfg"], seg_case["cfg"]
    params = seg_case["params"]
    opt = optax.adam(jschedule(jcfg)).init(ravel_pytree(params)[0])
    trainer = Trainer(tcfg, device="cpu")
    state = trainer.init_state(state=flax_train_state_to_torch(
        JState(step=np.int32(0), params=params, opt_state=opt),
        trainer.model))
    xyz, feats, mask = seg_case["block"]
    batch = {"xyz": xyz[None], "feats": feats[None], "mask": mask[None],
             "labels": seg_case["labels"][None]}
    loss, grad = trainer.loss_and_grad(state, batch, train=False)
    np.testing.assert_allclose(float(loss), seg_case["loss"], rtol=1e-4)
    want = seg_case["grads"]
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(grad.numpy(), want, rtol=1e-4, atol=1e-4)
    for leaf in trainer.layout:
        if leaf.path[-1] == "pw":
            assert leaf.view(grad).abs().max() > 0, leaf.key


@pytest.mark.parametrize("key", ["gpn_seg", "gpn_modelnet40"])
def test_layout_and_adam_moments_load(narrow, key):
    """``ravel_layout`` is ``ravel_pytree``'s order, and a JAX train state
    (params and Adam moments) loads leaf for leaf."""
    if key == "gpn_seg":
        jcfg, tcfg = _seg_cfgs()
    else:
        over = dict(data_num_points=256)
        jcfg = jconfig.modelnet40_config(**over)
        tcfg = tconfig.modelnet40_config(compute_dtype="float32", **over)
    n = jcfg.data.num_points
    xyz, feats, mask, _ = _block(3)
    args = (xyz[:n], feats[:n, :jcfg.data.feat_dim], mask[:n])
    params = random_params(jzoo.build_model(jcfg), *args, seed=30)
    vec, unravel = ravel_pytree(params)
    rng = np.random.RandomState(31)
    mu = rng.randn(vec.size).astype(np.float32)
    nu = rng.rand(vec.size).astype(np.float32)
    opt = optax.adam(jschedule(jcfg)).init(vec)
    opt = (opt[0]._replace(count=np.int32(3), mu=mu, nu=nu),
           opt[1]._replace(count=np.int32(3)))
    trainer = Trainer(tcfg, device="cpu")
    layout = trainer.layout
    assert len(layout) == len(jax.tree_util.tree_leaves(params))
    assert [leaf.path for leaf in layout] == [
        tuple(k.key for k in p)[1:]
        for p, _ in jax.tree_util.tree_leaves_with_path(params)]
    st = flax_train_state_to_torch(
        JState(step=np.int32(3), params=params, opt_state=opt),
        trainer.model)
    np.testing.assert_array_equal(st.params.numpy(), np.array(vec))
    np.testing.assert_array_equal(st.mu.numpy(), mu)
    np.testing.assert_array_equal(st.nu.numpy(), nu)
    assert int(st.count) == 3
    pw = next(leaf for leaf in layout if leaf.path[-1] == "pw")
    node = params
    for part in ("params",) + pw.path:
        node = node[part]
    np.testing.assert_array_equal(pw.view(st.params).numpy(),
                                  np.array(node))


@pytest.mark.parametrize("key", ["gpn_seg", "gpn_modelnet40"])
def test_init_draws_every_leaf_jax_draws(narrow, key):
    """No parameter that the JAX init makes non-zero is left zero by the
    port's seeded build (every ``pw`` is drawn from the generator), and
    every draw stays within its Glorot limit."""
    if key == "gpn_seg":
        jcfg, tcfg = _seg_cfgs()
    else:
        jcfg = jconfig.modelnet40_config(data_num_points=256)
        tcfg = tconfig.modelnet40_config(data_num_points=256)
    n = jcfg.data.num_points
    xyz, feats, mask, _ = _block(4)
    jparams = jzoo.build_model(jcfg).init(
        jax.random.PRNGKey(0), xyz[:n], feats[:n, :jcfg.data.feat_dim],
        mask[:n], False)
    model = tzoo.build_model(tcfg, torch.Generator().manual_seed(0), "cpu")
    layout = ravel_layout(model)
    flat = ravel_params(model, layout)
    jflat = np.array(ravel_pytree(jparams)[0])
    kinds = set()
    for leaf in layout:
        got = leaf.view(flat)
        want = jflat[leaf.offset:leaf.offset + leaf.size]
        assert bool(got.any()) == bool(np.any(want)), leaf.key
        if leaf.path[-1] in ("kernel", "pw"):
            kinds.add(leaf.path[-1])
            fan = sum(leaf.shape)
            assert got.abs().max() <= np.sqrt(6.0 / fan), leaf.key
    assert kinds == {"kernel", "pw"}


def _chip_smoke():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_counts_every_gpn_gather(narrow, monkeypatch):
    """``chip_smoke.gpn_gathers``, which phase 12 holds the card's launch
    counts to, names every windowed gather a bf16 ``gpn_seg`` forward
    makes, in order, with its rows, slots, width and dtype (recorded from
    the plain version on the CPU at 1024 points, levels 0 and 1 windowed):
    stage 0 gathers float32 rows, the later stages bf16."""
    from pointcloudsegmentation_tpu_torch.kernels import window_gather as wg

    cs = _chip_smoke()
    cfg = tconfig.s3dis_config(model="gpn_seg", data_num_points=N,
                               data_caps=CAPS)
    model = tzoo.build_model(cfg, torch.Generator().manual_seed(0), "cpu")
    xyz, feats, mask, _ = _block(5)
    seen = []
    plain = wg.gather_fwd_reference

    def record(f, lidx, window, tile):
        seen.append((f.shape[0], lidx.shape[1], f.shape[1], f.dtype))
        return plain(f, lidx, window, tile)

    monkeypatch.setattr(wg, "gather_fwd_reference", record)
    with torch.no_grad():
        model(_t(xyz), _t(feats), _t(mask))
    sizes = (N,) + CAPS
    gathers = cs.gpn_gathers(model, cfg)
    assert seen == [(sizes[lvl], k, f, dt)
                    for _, lvl, k, f, dt, _ in gathers]
    dts = {lvl: dt for what, lvl, _, _, dt, _ in gathers if what != "search"}
    assert dts == {0: torch.float32, 1: torch.bfloat16}
    fwd, step = cs.gpn_per_block(cfg)
    assert fwd == {"window_gather": len(seen)}
    assert step["window_dslab"] == step["window_dslab_map"] == sum(
        g[-1] for g in gathers) == len(seen) - 2
