"""The anchored-conv tail and the head variants of the port against the
JAX package, float32: ``GPNConv`` in its three modes, summed and per
anchor, with a trainable ``pmiu``; ``AnchorConv``; ``GPNConvV2``;
``compute_wlw``, ``DiffFeatsWLW`` and the four ``WLWConv`` forms;
``classifier_v2/v4/v5``.  Each module takes random flax weights through
``convert.load_flax_params`` (its ``ravel_layout`` and ``ravel_params``
against ``ravel_pytree``), runs on the windowed neighborhood (per-point
overflow slots) and on the global one of ``test_torch_gpn``'s block, and
its outputs and its gradient in every weight and in the input features
hold 1e-4 after dividing by max(1, the largest |JAX value|)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from pointcloudsegmentation_tpu.models import layers as jlayers
from pointcloudsegmentation_tpu.models import variants as jvariants
from pointcloudsegmentation_tpu.ops import anchors as janchors
from pointcloudsegmentation_tpu_torch.convert import (load_flax_params,
                                                      ravel_layout,
                                                      ravel_params)
from pointcloudsegmentation_tpu_torch.models import layers as tlayers
from pointcloudsegmentation_tpu_torch.models import variants as tvariants
from test_torch_archs import assert_close
from test_torch_gpn import KINDS, M, N, _flax_params, _t, nbrs  # noqa: F401

torch.set_num_threads(1)
F = 12   # the block's feature width


def check(jmod, tmod, jargs, targs, seed, grad_arg=1):
    """Random flax weights for ``jmod`` loaded into ``tmod``; every output
    against the flax module's; the gradient of a seeded weighting of the
    first output in every weight and in argument ``grad_arg`` (the
    features; None for none) against ``jax.grad``.  Returns the port's
    outputs."""
    params = _flax_params(jmod, jargs, {}, seed)
    load_flax_params(tmod, params)
    flat, _ = ravel_pytree(params)
    layout = ravel_layout(tmod)
    assert {leaf.key for leaf in layout} == {
        k for k, _ in tmod.named_parameters()}
    np.testing.assert_array_equal(ravel_params(tmod, layout).numpy(),
                                  np.array(flat))
    shape = jax.eval_shape(lambda: jmod.apply(params, *jargs))
    shape = shape[0] if isinstance(shape, tuple) else shape
    w = np.random.RandomState(seed + 100).randn(*shape.shape).astype(
        np.float32)

    def loss(p, x):
        a = list(jargs)
        if grad_arg is not None:
            a[grad_arg] = x
        out = jmod.apply(p, *a)
        out = out if isinstance(out, tuple) else (out,)
        return jnp.sum(out[0] * w), out

    x0 = jargs[grad_arg] if grad_arg is not None else None
    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, x0)
    targs = list(targs)
    if grad_arg is not None:
        targs[grad_arg] = targs[grad_arg].clone().requires_grad_(True)
    got = tmod(*targs)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, wv in zip(got, want):
        assert tuple(g.shape) == wv.shape and g.dtype == torch.float32
        assert_close(g.detach().numpy(), np.array(wv))
    (got[0] * _t(w)).sum().backward()
    named = dict(tmod.named_parameters())
    gflat, _ = ravel_pytree(gp)
    gflat = np.array(gflat)
    for leaf in layout:
        assert_close(named[leaf.key].grad.numpy(),
                     leaf.view(torch.from_numpy(gflat)).numpy(), leaf.key)
    if grad_arg is not None:
        assert np.abs(np.array(gx)).max() > 0
        assert_close(targs[grad_arg].grad.numpy(), np.array(gx))
    return got


def _args(nbrs, kind):
    jn, tn, sxyz = nbrs[kind]
    f = nbrs["feats"]
    return (sxyz, f, jn), (_t(sxyz), _t(f), tn)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("no_sum", [False, True])
@pytest.mark.parametrize("mode", ["xyz", "feats", "xyz_feats"])
def test_gpn_conv_modes(nbrs, kind, mode, no_sum):
    """The three modes, summed over the anchors (bias [out]) and per
    anchor (bias [m·out]), with a trainable ``pmiu`` (its gradient
    included)."""
    a, ta = _args(nbrs, kind)
    grad_arg = None if mode == "xyz" else 1
    tmod = tlayers.GPNConv(F, M, 6, mode=mode, no_sum=no_sum,
                           pmiu_trainable=True)
    assert "pmiu" in tmod.state_dict()
    np.testing.assert_array_equal(tmod.pmiu.detach().numpy(),
                                  janchors.sphere_kmeans_anchors(M))
    out, lw, _ = check(jlayers.GPNConv(M, 6, mode=mode, no_sum=no_sum,
                                       pmiu_trainable=True),
                       tmod, a, ta, seed=11, grad_arg=grad_arg)
    assert out.shape == (N, M * 6 if no_sum else 6)
    assert not lw[~ta[2].mask].any()


def test_gpn_conv_no_bias_no_activation(nbrs):
    a, ta = _args(nbrs, "windowed")
    tmod = tlayers.GPNConv(F, M, 5, use_bias=False, activation=None)
    assert tmod.bias is None and "pmiu" not in tmod.state_dict()
    out, _, _ = check(jlayers.GPNConv(M, 5, use_bias=False, activation=None),
                      tmod, a, ta, seed=12)
    assert (out < 0).any()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("trainable", [True, False])
def test_anchor_conv(nbrs, kind, trainable):
    a, ta = _args(nbrs, kind)
    tmod = tlayers.AnchorConv(F, 10, 6, 3, trainable_anchor=trainable)
    np.testing.assert_array_equal(tmod.anchor.detach().numpy(),
                                  janchors.sphere_kmeans_anchors(6).T)
    assert ("anchor" in tmod.state_dict()) == trainable
    check(jlayers.AnchorConv(10, 6, 3, trainable_anchor=trainable), tmod,
          a, ta, seed=13)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode", ["xyz", "feats"])
def test_gpn_conv_v2(nbrs, kind, mode):
    a, ta = _args(nbrs, kind)
    jmod = jvariants.GPNConvV2(M, 7, mode=mode, scale_val=2.0,
                               pmiu_trainable=True)
    tmod = tvariants.GPNConvV2(F, M, 7, mode=mode, scale_val=2.0,
                               pmiu_trainable=True)
    assert tuple(tmod.pw.shape) == (M * (3 if mode == "xyz" else F), 7)
    check(jmod, tmod, a, ta, seed=14, grad_arg=None if mode == "xyz" else 1)


@pytest.mark.parametrize("kind", KINDS)
def test_compute_wlw(nbrs, kind):
    (sxyz, _, jn), (tsx, _, tn) = _args(nbrs, kind)
    pmiu = janchors.sphere_kmeans_anchors(M)
    want = np.array(jvariants.compute_wlw(sxyz, jn, pmiu, 1.5))
    got = tvariants.compute_wlw(tsx, tn, _t(pmiu), 1.5).numpy()
    assert_close(got, want)
    np.testing.assert_allclose(got.sum(1)[np.array(jn.mask).any(1)], 1.0,
                               atol=1e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_diff_feats_wlw(nbrs, kind):
    _, (_, tf, tn) = _args(nbrs, kind)
    jn = nbrs[kind][0]
    got, = check(jvariants.DiffFeatsWLW(M, (8, 6)),
                 tvariants.DiffFeatsWLW(F, M, (8, 6)),
                 (nbrs["feats"], jn), (tf, tn), seed=15, grad_arg=0)
    assert not got[~tn.mask].any()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("use_xyz", [True, False])
@pytest.mark.parametrize("mode", ["sum", "concat"])
def test_wlw_conv(nbrs, kind, mode, use_xyz):
    """The four forms on weights from ``DiffFeatsWLW`` (the port's and
    JAX's agree, ``test_diff_feats_wlw``), fed to both sides as data."""
    (sxyz, f, jn), (tsx, tf, tn) = _args(nbrs, kind)
    dw = jvariants.DiffFeatsWLW(M, (8,))
    wlw = np.array(dw.apply(_flax_params(dw, (f, jn), {}, 16), f, jn))
    grad_arg = None if use_xyz else 1
    check(jvariants.WLWConv(M, 9, mode=mode, use_xyz=use_xyz),
          tvariants.WLWConv(F, M, 9, mode=mode, use_xyz=use_xyz),
          (sxyz, f, jn, wlw), (tsx, tf, tn, _t(wlw)), seed=17,
          grad_arg=grad_arg)


@pytest.mark.parametrize("name", ["v2", "v4", "v5"])
@pytest.mark.parametrize("premixed", [False, True])
def test_classifiers(name, premixed):
    rng = np.random.RandomState(18)
    d0 = {"v2": 256, "v4": 256, "v5": 512}[name]
    width = d0 if premixed else 300
    x = rng.randn(40, width).astype(np.float32)
    pf = rng.randn(40, 20).astype(np.float32)
    jmod = getattr(jlayers, f"classifier_{name}")(13, premixed=premixed)
    if name == "v2":
        tmod = tlayers.classifier_v2(13, width, premixed=premixed)
        jargs, targs = (x,), (_t(x),)
    else:
        tmod = getattr(tlayers, f"classifier_{name}")(13, width, 20,
                                                      premixed=premixed)
        jargs, targs = (x, pf), (_t(x), _t(pf))
    assert hasattr(tmod, "class_mlp1") != premixed
    check(jmod, tmod, jargs, targs, seed=19, grad_arg=0)
    # the unfactored form is the default, as the JAX constructors'
    assert not tlayers.classifier_v5(13, 512, 20).premixed
