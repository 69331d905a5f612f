"""The shared overflow edge list (``ov_mode="edges"``) of the port against
the JAX package, float32: the windowed search's edge list slot for slot
(``sel_mode="slab"``, 1024 points, tile and window 128), the views of a
WindowedNeighborhood with no overflow columns, the edge path of
``PointNetConvFast`` and of ``PointNetConv`` (growth, noconcat, xyz-only)
forward and through ``jax.vjp`` to 1e-5, ``tiny_s3dis`` with edges end to
end (logits and every parameter gradient within 1e-4 of scale) and the
flagship arch with edges layer by layer at 1024 points (caps (1024, 256):
levels 0 and 1 windowed, so both carry an edge list)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudsegmentation_tpu.data import toy
from pointcloudsegmentation_tpu.models import fast_conv as jfc
from pointcloudsegmentation_tpu.models import layers as jl
from pointcloudsegmentation_tpu.ops import hierarchy as jhier
from pointcloudsegmentation_tpu.ops import morton as jmorton
from pointcloudsegmentation_tpu.ops import neighbors as jnb
from pointcloudsegmentation_tpu.ops import search as jsearch
from pointcloudsegmentation_tpu.train import config as jconfig
from pointcloudsegmentation_tpu.train.model_zoo import build_model as jbuild
from pointcloudsegmentation_tpu_torch import config as tconfig
from pointcloudsegmentation_tpu_torch.convert import (flax_to_state_dict,
                                                      load_flax_params)
from pointcloudsegmentation_tpu_torch.models import fast_conv as tfc
from pointcloudsegmentation_tpu_torch.models import layers as tl
from pointcloudsegmentation_tpu_torch.ops import hierarchy as thier
from pointcloudsegmentation_tpu_torch.ops import morton as tmorton
from pointcloudsegmentation_tpu_torch.ops import neighbors as tnb
from pointcloudsegmentation_tpu_torch.ops import search as tsearch
from pointcloudsegmentation_tpu_torch.train.model_zoo import \
    build_model as tbuild
from test_torch_archs import assert_close, pyramids
from test_torch_model import _block, random_params, random_tree

torch.set_num_threads(1)
N = 1024
BANDS = ((0.0, 0.15, 16), (0.1, 0.3, 16))
TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cloud(seed=0, n=N, n_pad=24):
    rng = np.random.RandomState(seed)
    xyz = toy.synthetic_room_block(rng, n=n)["xyz"]
    mask = np.ones(n, bool)
    mask[-n_pad:] = False
    xyz, mask, _ = jmorton.sort_block(xyz, mask, 0.0375, 3.0)
    return np.array(xyz), np.array(mask)


def _search(xyz, mask, bands, edge_ratio, return_sxyz=True):
    kw = dict(tile=128, window=128, cand_k=64, return_sxyz=return_sxyz,
              ov_mode="edges", edge_ratio=edge_ratio)
    jres = jsearch.windowed_multi_band_neighbors(
        jnp.asarray(xyz), jnp.asarray(mask), bands, sel_mode="slab", **kw)
    tres = tsearch.windowed_multi_band_neighbors(
        _t(xyz), _t(mask), bands, chunk=2048, sel_mode="slab", **kw)
    return jres, tres


@pytest.mark.parametrize("edge_ratio,band", [(4, None), (1, (0.0, 0.6, 16))])
def test_edge_list_against_jax(edge_ratio, band):
    """Ratio 4 on two bands (demand under the cap), and ratio 1 on a
    0.6 m band whose demand exceeds the cap of N rows: the rank-major fill
    then drops the farthest ranks level-wide, the same rows as JAX's."""
    xyz, mask = _cloud()
    bands = BANDS if band is None else (band,)
    jres, tres = _search(xyz, mask, bands, edge_ratio)
    assert len(tres) == len(bands)
    te0 = tres[0][2]
    for (jw, jsx, je), (tw, tsx, te) in zip(jres, tres):
        assert te is te0                       # one list for every band
        for f in ("center", "nbr", "mask"):
            got = getattr(te, f).numpy()
            assert got.shape == (edge_ratio * N,)
            np.testing.assert_array_equal(got, np.array(getattr(je, f)), f)
        for f in ("sxyz", "d2"):
            np.testing.assert_allclose(getattr(te, f).numpy(),
                                       np.array(getattr(je, f)), atol=1e-6)
        np.testing.assert_array_equal(tw.lidx.numpy(), np.array(jw.lidx))
        np.testing.assert_array_equal(tw.wmask.numpy(), np.array(jw.wmask))
        np.testing.assert_allclose(tsx.numpy(), np.array(jsx), atol=1e-6)
        assert tuple(tw.ov_idx.shape) == (N, 0) and tw.pool_idx is None
    c, m = te0.center.numpy(), te0.mask.numpy()
    assert (np.diff(c) >= 0).all() and m.any()
    k = int(m.sum())
    assert m[:k].all() and not m[k:].any()     # a contiguous prefix
    assert (c[~m] == N - 1).all()
    if band is not None:                       # the cap binds
        _, (full,) = _search(xyz, mask, bands, 16)
        assert int(full[2].mask.sum()) > N == int(m.sum())
    # without sxyz: (neighborhood, edges) pairs, the same list
    pair = _search(xyz, mask, bands, edge_ratio, False)[1][0]
    assert len(pair) == 2
    np.testing.assert_array_equal(pair[1].nbr.numpy(), te0.nbr.numpy())


def test_windowed_views_without_overflow_columns():
    """Ko = 0: mask, counts, global_idx, to_neighborhood, the gather and
    the masked max equal JAX's on the same neighborhood."""
    xyz, mask = _cloud(1)
    jres, tres = _search(xyz, mask, BANDS[:1], 4)
    (jw, _, _), (tw, _, _) = jres[0], tres[0]
    np.testing.assert_array_equal(tw.mask.numpy(), np.array(jw.mask))
    np.testing.assert_array_equal(tw.counts().numpy(), np.array(jw.counts()))
    np.testing.assert_array_equal(tw.global_idx.numpy(),
                                  np.array(jw.global_idx))
    tn = tw.to_neighborhood()
    np.testing.assert_array_equal(tn.idx.numpy(),
                                  np.array(jw.to_neighborhood().idx))
    feats = np.random.RandomState(2).randn(N, 5).astype(np.float32)
    g = tnb.gather_neighbors(_t(feats), tw)
    np.testing.assert_array_equal(
        g.numpy(), np.array(jnb.gather_neighbors(jnp.asarray(feats), jw)))
    np.testing.assert_array_equal(
        tnb.masked_max(g, tw).numpy(),
        np.array(jnb.masked_max(jnp.asarray(g.numpy()), jw)))


@pytest.fixture(scope="module")
def edge_case():
    """Band (0.1, 0.3) of a sorted block with its edge list (ratio 4), both
    sides, the windowed sxyz divided by the conv's rescale 0.3, and 12-wide
    features."""
    xyz, mask = _cloud(3)
    jres, tres = _search(xyz, mask, BANDS, 4)
    (jw, jsx, je), (tw, _, te) = jres[1], tres[1]
    assert np.array(je.band_mask(0.1, 0.3)).sum() > 50
    feats = np.random.RandomState(4).randn(N, 12).astype(np.float32)
    return dict(jw=jw, je=je, tw=tw, te=te, sxyz=np.array(jsx) / 0.3,
                feats=feats, mask=mask)


def close(got, want, err_msg=""):
    """``got`` within 1e-5 of ``want`` once both are divided by max(1, the
    largest |want|): a weight's gradient sums thousands of slot and edge
    terms in another order, and reaches about 60 here."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale,
                               err_msg=err_msg, **TOL)


def _vjp_compare(jmod, tmod, c, use_feats=True):
    """Forward and the vjp in the weights and features against
    ``jax.vjp`` with a seeded cotangent, to 1e-5 of scale (``close``)."""
    feats = c["feats"] if use_feats else None
    ekw = dict(edges=c["je"], edge_band=(0.1, 0.3), edge_rescale=0.3)
    shapes = jax.eval_shape(lambda: jmod.init(
        jax.random.PRNGKey(0), c["sxyz"], feats, c["jw"], **ekw))
    params = random_tree(shapes, 5)

    def f(p, x):
        return jmod.apply(p, c["sxyz"], x, c["jw"], **ekw)

    want, vjp = jax.vjp(f, params, feats)
    ct = np.random.RandomState(6).randn(*want.shape).astype(np.float32)
    gp, gx = vjp(jnp.asarray(ct))
    load_flax_params(tmod, params)
    tx = _t(feats).requires_grad_(True) if use_feats else None
    got = tmod(_t(c["sxyz"]), tx, c["tw"], edges=c["te"],
               edge_band=(0.1, 0.3), edge_rescale=0.3)
    close(got.detach().numpy(), want)
    (got * _t(ct)).sum().backward()
    grads = flax_to_state_dict(jax.tree_util.tree_map(np.array, gp))
    named = dict(tmod.named_parameters())
    assert set(grads) == set(named)
    for k, g in grads.items():
        close(named[k].grad.numpy(), g.numpy(), k)
    if use_feats:
        close(tx.grad.numpy(), gx)
    # the edges reach points that no windowed slot serves
    only_e = ~np.array(c["jw"].mask).any(1) & np.isin(
        np.arange(N), np.array(c["je"].center)[
            np.array(c["je"].band_mask(0.1, 0.3))])
    return only_e, got


def test_pointnet_conv_fast_edges(edge_case):
    only_e, got = _vjp_compare(jfc.PointNetConvFast((8, 8, 16), 24),
                               tfc.PointNetConvFast(12, (8, 8, 16), 24),
                               edge_case)
    assert (got.detach().numpy()[only_e] != 0).any()


@pytest.mark.parametrize("kind", ["growth", "noconcat", "nofeats"])
def test_pointnet_conv_edges(edge_case, kind):
    use_feats = kind != "nofeats"
    jmod = jl.PointNetConv((8, 12), 16, concat_growth=kind != "noconcat",
                           use_feats=use_feats)
    tmod = tl.PointNetConv(12 if use_feats else 0, (8, 12), 16,
                           concat_growth=kind != "noconcat",
                           use_feats=use_feats)
    _vjp_compare(jmod, tmod, edge_case, use_feats)


def _edges_model(jcfg):
    jmodel = jbuild(jcfg)
    return jmodel.clone(encoder=jmodel.encoder.clone(ov_mode="edges"))


def test_tiny_s3dis_edges_end_to_end():
    """``build_model(cfg, ov_mode="edges")`` at 1024 points (level 0
    windowed): the logits through the whole block pipeline, then the
    gradient in every encoder parameter of a seeded weighting of the
    encoder's two outputs (over the Morton sort, the pyramid, the search
    and the convs' slot and edge paths), within 1e-4 of scale.  The
    gradient stops before the head: its 512-wide ReLU has pre-activations
    within float32 reorder noise of 0 at this size, where the derivative
    of either side may jump."""
    caps = (256, 64)
    jmodel = _edges_model(jconfig.s3dis_config(
        model="tiny_s3dis", data_num_points=N, data_caps=caps))
    xyz, feats, mask = _block(5, N, 40)
    params = random_params(jmodel, xyz, feats, mask, seed=5)
    want = jax.jit(lambda p: jmodel.apply(p, xyz, feats, mask, False))(
        params)
    tmodel = tbuild(tconfig.s3dis_config(
        model="tiny_s3dis", compute_dtype="float32", data_num_points=N,
        data_caps=caps), device="cpu", ov_mode="edges")
    assert tmodel.encoder.ov_mode == "edges"
    load_flax_params(tmodel, params)
    with torch.no_grad():
        got = tmodel(_t(xyz), _t(feats), _t(mask))
    assert_close(got.numpy(), np.array(want))

    xs, ms, _, fs = jmorton.sort_block(xyz, mask, 0.0375, 3.0, feats)
    jpyr = jhier.build_pyramid(xs, ms, (0.15, 0.45), caps, 3.0, True)
    rng = np.random.RandomState(7)
    wz = rng.randn(N, tmodel.encoder.out_width).astype(np.float32)
    wl = rng.randn(N, tmodel.encoder.stage0_width).astype(np.float32)
    wz[~np.array(ms)] = wl[~np.array(ms)] = 0.0

    def loss(p):
        z, lf = jmodel.encoder.apply({"params": p}, jpyr, fs)
        return jnp.sum(z * wz) + jnp.sum(lf * wl)

    gp = jax.jit(jax.grad(loss))(params["params"]["encoder"])
    txs, tms, _, tfs = tmorton.sort_block(_t(xyz), _t(mask), 0.0375, 3.0,
                                          _t(feats))
    tpyr = thier.build_pyramid(txs, tms, (0.15, 0.45), caps, 3.0, True)
    z, lf = tmodel.encoder(tpyr, tfs)
    ((z * _t(wz)).sum() + (lf * _t(wl)).sum()).backward()
    named = dict(tmodel.encoder.named_parameters())
    grads = flax_to_state_dict(jax.tree_util.tree_map(np.array, gp))
    assert set(grads) == set(named)
    for k, g in grads.items():
        assert np.abs(g.numpy()).max() > 0, k
        assert_close(named[k].grad.numpy(), g.numpy(), k)


def test_flagship_edges_layer_by_layer():
    """The flagship's encoder with edges on the JAX pyramid: every child
    module's output against flax ``capture_intermediates``, both encoder
    outputs and the head's logits."""
    jcfg = jconfig.s3dis_config(data_num_points=N, data_caps=(1024, 256))
    jmodel = _edges_model(jcfg)
    xyz, feats, mask = _block(6, N, 24)
    params = random_params(jmodel, xyz, feats, mask, seed=6)
    jpyr, tpyr, sfeats = pyramids((xyz, feats, mask), jcfg)
    p = params["params"]
    (z, lf), inter = jax.jit(lambda v: jmodel.encoder.apply(
        v, jpyr, sfeats, capture_intermediates=True,
        mutable=["intermediates"]))({"params": p["encoder"]})
    inter = inter["intermediates"]
    tmodel = tbuild(tconfig.s3dis_config(
        compute_dtype="float32", data_num_points=N, data_caps=(1024, 256)),
        device="cpu", ov_mode="edges")
    load_flax_params(tmodel, params)
    outs = {}
    for name, mod in tmodel.encoder.named_children():
        mod.register_forward_hook(
            lambda m, a, out, name=name: outs.setdefault(name, out))
    with torch.no_grad():
        tz, tlf = tmodel.encoder(tpyr, _t(sfeats))
    assert len(outs) == len(inter) - 1, sorted(outs)   # flax adds __call__
    for name, out in outs.items():
        assert_close(out.numpy(), inter[name]["__call__"][0], name)
    assert_close(tlf.numpy(), lf)
    assert_close(tz.numpy(), z)
