"""Each ported layer against its flax counterpart with the same (converted)
weights, float32, to 1e-5."""
import jax
import numpy as np
import pytest
import torch

from pointcloudsegmentation_tpu.data import toy
from pointcloudsegmentation_tpu.models import fast_conv as jfc
from pointcloudsegmentation_tpu.models import layers as jl
from pointcloudsegmentation_tpu.ops import morton as jmorton
from pointcloudsegmentation_tpu.ops import search as jsearch
from pointcloudsegmentation_tpu_torch.convert import load_flax_params
from pointcloudsegmentation_tpu_torch.models import fast_conv as tfc
from pointcloudsegmentation_tpu_torch.models import layers as tl
from pointcloudsegmentation_tpu_torch.ops.types import (Neighborhood,
                                                        WindowedNeighborhood)

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _run(jmod, tmod, *args):
    """Init the flax module, load its params into the torch module, and
    return both outputs on ``args`` (numpy)."""
    params = jmod.init(jax.random.PRNGKey(0), *args)
    params = jax.tree_util.tree_map(np.array, params)
    load_flax_params(tmod, params)
    want = np.array(jmod.apply(params, *args))
    with torch.no_grad():
        got = tmod(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                     for a in args])
    return got.numpy(), want


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("bias", [True, False])
def test_dense(bias):
    got, want = _run(jl.Dense(7, use_bias=bias),
                     tl.Dense(5, 7, bias=bias), _x(11, 5))
    np.testing.assert_allclose(got, want, **TOL)


def test_growth_mlp():
    got, want = _run(jl.GrowthMLP((8, 8, 16), 32),
                     tl.GrowthMLP(6, (8, 8, 16), 32), _x(40, 6))
    np.testing.assert_allclose(got, want, **TOL)


def test_growth_mlp_new_last():
    """new_first=False is the deconv decoder's order: [x ‖ c]."""
    got, want = _run(jl.GrowthMLP((8, 8, 16), 32, new_first=False),
                     tl.GrowthMLP(6, (8, 8, 16), 32, new_first=False),
                     _x(40, 6))
    np.testing.assert_allclose(got, want, **TOL)


def test_fc_embed():
    got, want = _run(jl.FCEmbed(16), tl.FCEmbed(9, 16), _x(40, 9))
    np.testing.assert_allclose(got, want, **TOL)


def test_pointnet_pool_mlp():
    got, want = _run(jl.PointNetPoolMLP((8, 8, 16), 32),
                     tl.PointNetPoolMLP(10, (8, 8, 16), 32),
                     _x(40, 3), _x(40, 10, seed=1))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("pfeat_dim", [12, 40])
def test_seg_classifier(pfeat_dim):
    got, want = _run(jl.SegClassifier(13, premixed=True),
                     tl.SegClassifier(13, 512, pfeat_dim, premixed=True),
                     _x(30, 512), _x(30, pfeat_dim, seed=1))
    np.testing.assert_allclose(got, want, **TOL)


def test_seg_classifier_unfactored():
    """The deconv net's head: class_mlp1 maps the wide decoder output to
    512 before the relu (the JAX ``SegClassifier(premixed=False)``)."""
    got, want = _run(jl.SegClassifier(13), tl.SegClassifier(
        13, 300, 40, premixed=False), _x(30, 300), _x(30, 40, seed=1))
    np.testing.assert_allclose(got, want, **TOL)
    with pytest.raises(ValueError):
        tl.SegClassifier(13, 300, 40, premixed=True)


def test_seg_classifier_dropout_uses_generator():
    m = tl.SegClassifier(13, 512, 12, premixed=True)
    tl.init_glorot_(m, torch.Generator().manual_seed(0))
    x, p = torch.randn(30, 512), torch.randn(30, 12)
    a = m(x, p, True, torch.Generator().manual_seed(1))
    b = m(x, p, True, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, m(x, p))
    with pytest.raises(ValueError):
        m(x, p, True)


def test_init_glorot_is_seeded_and_bounded():
    m1, m2 = tl.GrowthMLP(6, (8,), 4), tl.GrowthMLP(6, (8,), 4)
    tl.init_glorot_(m1, torch.Generator().manual_seed(0))
    tl.init_glorot_(m2, torch.Generator().manual_seed(0))
    for a, b in zip(m1.parameters(), m2.parameters()):
        assert torch.equal(a, b)
    lim = np.sqrt(6.0 / (6 + 8))
    w = m1.fc_0.weight.detach()
    assert float(w.abs().max()) <= lim and float(w.std()) > 0.3 * lim
    assert float(m1.fc_0.bias.detach().abs().max()) == 0.0


@pytest.mark.parametrize("fc_dims,out", [((8, 8, 16), 32), ((16, 16, 32), 64)])
def test_pointnet_conv_fast_windowed(fc_dims, out):
    mask, sxyz, jwn, twn = _windowed_case()
    feats = _x(len(mask), 20, seed=3)
    jmod = jfc.PointNetConvFast(fc_dims, out)
    params = jax.tree_util.tree_map(
        np.array, jmod.init(jax.random.PRNGKey(0), sxyz, feats, jwn))
    want = np.array(jmod.apply(params, sxyz, feats, jwn))
    tmod = load_flax_params(tfc.PointNetConvFast(20, fc_dims, out), params)
    with torch.no_grad():
        got = tmod(_t(sxyz), _t(feats), twn).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[~mask] == 0.0)   # no valid slot -> 0


def _t(a):
    return torch.from_numpy(np.array(a))


def _windowed_case():
    """A 1024-point toy block's windowed neighborhood (band 0.1-0.45 m, 24
    slots, 8 overflow slots read through the tile-shared pool, some of
    them valid) from the JAX search: (mask, sxyz / 0.45, the JAX
    neighborhood, the same as the port's WindowedNeighborhood)."""
    rng = np.random.RandomState(7)
    n = 1024
    xyz = toy.synthetic_room_block(rng, n=n)["xyz"]
    mask = np.ones(n, bool)
    mask[-30:] = False
    xyz, mask, _ = jmorton.sort_block(xyz, mask, 0.0375, 3.0)
    xyz, mask = np.array(xyz), np.array(mask)
    (jwn, sxyz), = jsearch.windowed_multi_band_neighbors(
        xyz, mask, ((0.1, 0.45, 24),), tile=256, window=256, cand_k=32,
        ov_slots=8, chunk=1024, return_sxyz=True, ov_pool_size=256,
        sel_mode="slab")
    assert np.array(jwn.ov_mask).any()
    twn = WindowedNeighborhood(lidx=_t(jwn.lidx), wmask=_t(jwn.wmask),
                               ov_idx=_t(jwn.ov_idx), ov_mask=_t(jwn.ov_mask),
                               window=256, tile=256, pool_idx=_t(jwn.pool_idx))
    return mask, np.array(sxyz) / 0.45, jwn, twn


@pytest.mark.parametrize("concat_growth", [True, False])
def test_pointnet_conv_with_feats_windowed(concat_growth):
    """The full conv on gathered raw features, [center ‖ neighbor ‖ sxyz]
    per slot: the growth form (Semantic3D's pre-stage) and the plain-MLP
    noconcat form (the baseline's convs), over the windowed and the pooled
    overflow slots."""
    mask, sxyz, jwn, twn = _windowed_case()
    feats = _x(len(mask), 13, seed=4)
    jmod = jl.PointNetConv((16, 12, 8), 24, concat_growth=concat_growth)
    params = jax.tree_util.tree_map(
        np.array, jmod.init(jax.random.PRNGKey(0), sxyz, feats, jwn))
    want = np.array(jmod.apply(params, sxyz, feats, jwn))
    tmod = load_flax_params(tl.PointNetConv(
        13, (16, 12, 8), 24, concat_growth=concat_growth), params)
    assert tmod.fc_0.in_features == 2 * 13 + 3
    with torch.no_grad():
        got = tmod(_t(sxyz), _t(feats), twn).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[~mask] == 0.0)   # no valid slot -> 0


def test_pointnet_conv_xyz_only():
    """The ScanNet arch's first conv: growth MLP on sxyz alone, masked max
    over the slots, 0 for a point without a valid slot."""
    from pointcloudsegmentation_tpu.ops.types import \
        Neighborhood as JNeighborhood

    rng = np.random.RandomState(5)
    n, k = 200, 12
    sxyz = _x(n, k, 3, seed=4)
    mask = rng.rand(n, k) < 0.6
    mask[:7] = False
    jnbr = JNeighborhood(idx=np.zeros((n, k), np.int32), mask=mask)
    jmod = jl.PointNetConv((16, 16, 16), 48, use_feats=False)
    params = jax.tree_util.tree_map(
        np.array, jmod.init(jax.random.PRNGKey(0), sxyz, None, jnbr))
    want = np.array(jmod.apply(params, sxyz, None, jnbr))
    tmod = load_flax_params(tl.PointNetConv(0, (16, 16, 16), 48,
                                            use_feats=False), params)
    tnbr = Neighborhood(idx=_t(jnbr.idx), mask=_t(mask))
    with torch.no_grad():
        got = tmod(_t(sxyz), None, tnbr).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[:7] == 0.0)
