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
from pointcloudsegmentation_tpu_torch.ops.types import WindowedNeighborhood

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
                     tl.SegClassifier(13, 512, pfeat_dim),
                     _x(30, 512), _x(30, pfeat_dim, seed=1))
    np.testing.assert_allclose(got, want, **TOL)


def test_seg_classifier_dropout_uses_generator():
    m = tl.SegClassifier(13, 512, 12)
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
    sxyz = np.array(sxyz) / 0.45
    feats = _x(n, 20, seed=3)
    jmod = jfc.PointNetConvFast(fc_dims, out)
    params = jax.tree_util.tree_map(
        np.array, jmod.init(jax.random.PRNGKey(0), sxyz, feats, jwn))
    want = np.array(jmod.apply(params, sxyz, feats, jwn))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    twn = WindowedNeighborhood(lidx=t(jwn.lidx), wmask=t(jwn.wmask),
                               ov_idx=t(jwn.ov_idx), ov_mask=t(jwn.ov_mask),
                               window=256, tile=256, pool_idx=t(jwn.pool_idx))
    tmod = load_flax_params(tfc.PointNetConvFast(20, fc_dims, out), params)
    with torch.no_grad():
        got = tmod(t(sxyz), t(feats), twn).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[~mask] == 0.0)   # no valid slot -> 0
