"""The port's geometry, pooling and toy-data helpers against the JAX
package: ``covariance_feats`` (on a windowed and a global neighborhood,
and ``covariance_feats_radius``) and ``normalize_rgb`` within 1e-6,
``estimate_normals`` up to sign where the smallest eigenvalue is isolated
(and on ``tests/test_components.py``'s noisy plane), ``annulus_neighbors``
slot for slot, ``voxel_majority_label`` exactly (ties to the lowest
class), ``average_downsample`` (integers exact, floats within 1e-6), and
``toy_batches(kind="toy")``'s arrays equal to JAX's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudsegmentation_tpu.data import toy as jtoy
from pointcloudsegmentation_tpu.ops import geometry as jgeo
from pointcloudsegmentation_tpu.ops import hierarchy as jhier
from pointcloudsegmentation_tpu.ops import search as jsearch
from pointcloudsegmentation_tpu.ops import voxelize as jvox
from pointcloudsegmentation_tpu_torch.data import toy as ttoy
from pointcloudsegmentation_tpu_torch.ops import geometry as tgeo
from pointcloudsegmentation_tpu_torch.ops import hierarchy as thier
from pointcloudsegmentation_tpu_torch.ops import search as tsearch
from pointcloudsegmentation_tpu_torch.ops import voxelize as tvox
from pointcloudsegmentation_tpu_torch.ops.types import Neighborhood
from test_torch_gpn import KINDS, _t, nbrs  # noqa: F401

torch.set_num_threads(1)


@pytest.mark.parametrize("kind", KINDS)
def test_covariance_feats(nbrs, kind):
    jn, tn, _ = nbrs[kind]
    xyz = nbrs["xyz"]
    want = np.array(jgeo.covariance_feats(jnp.asarray(xyz), jn))
    got = tgeo.covariance_feats(_t(xyz), tn).numpy()
    assert got.shape == (len(xyz), 9)
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert not got[~np.array(jn.mask).any(1)].any()


def test_covariance_feats_radius():
    rng = np.random.RandomState(1)
    xyz = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    mask = rng.rand(300) > 0.1
    want = np.array(jgeo.covariance_feats_radius(xyz, mask, 0.2, k=12,
                                                 chunk=128))
    got = tgeo.covariance_feats_radius(_t(xyz), _t(mask), 0.2, k=12,
                                       chunk=128).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_normalize_rgb():
    rgb = np.random.RandomState(2).randint(0, 256, (50, 3)).astype(
        np.float32)
    got = tgeo.normalize_rgb(_t(rgb)).numpy()
    np.testing.assert_allclose(got, np.array(jgeo.normalize_rgb(rgb)),
                               atol=1e-6)
    assert got.min() >= -1.0 and got.max() <= 1.0


@pytest.mark.parametrize("kind", KINDS)
def test_estimate_normals(nbrs, kind):
    """Against JAX's eigenvectors with |dot|, on the points whose two
    smallest covariance eigenvalues are well apart (elsewhere the normal
    is ill-defined); points without a valid neighbor get zeros."""
    jn, tn, _ = nbrs[kind]
    xyz = nbrs["xyz"]
    want = np.array(jgeo.estimate_normals(jnp.asarray(xyz), jn))
    got = tgeo.estimate_normals(_t(xyz), tn).numpy()
    has = np.array(jn.mask).any(1)
    assert not got[~has].any()
    ev = np.linalg.eigvalsh(np.array(
        tgeo._local_covariance(_t(xyz), tn), np.float64))
    iso = has & (ev[:, 1] - ev[:, 0] > 1e-3 * np.maximum(ev[:, 2], 1e-12))
    assert iso.mean() > 0.3
    dot = np.abs((got * want).sum(1))
    np.testing.assert_allclose(dot[iso], 1.0, atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(got[has], axis=1), 1.0,
                               atol=1e-5)
    assert (got[has][:, 2] >= 0).all()


def test_estimate_normals_plane():
    """``tests/test_components.py``'s noisy z = 0 plane: normals near +z,
    and equal to JAX's up to sign."""
    rng = np.random.RandomState(0)
    xyz = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    xyz[:, 2] = 0.001 * rng.randn(200)
    mask = np.ones(200, bool)
    jn = jsearch.radius_neighbors(jnp.asarray(xyz), jnp.asarray(mask), 0.4,
                                  12, chunk=64)
    tn = Neighborhood(idx=_t(jn.idx), mask=_t(jn.mask))
    want = np.array(jgeo.estimate_normals(jnp.asarray(xyz), jn))
    got = tgeo.estimate_normals(_t(xyz), tn).numpy()
    assert np.abs(got[:, 2]).mean() > 0.99
    np.testing.assert_allclose(np.abs((got * want).sum(1)), 1.0, atol=1e-4)


@pytest.mark.parametrize("mn,mx,k", [(0.1, 0.25, 12), (0.05, 0.4, 24)])
def test_annulus_neighbors(mn, mx, k):
    rng = np.random.RandomState(3)
    xyz = rng.uniform(0, 1, (400, 3)).astype(np.float32)
    mask = rng.rand(400) > 0.05
    want = jsearch.annulus_neighbors(jnp.asarray(xyz), jnp.asarray(mask),
                                     mn, mx, k, chunk=128)
    got = tsearch.annulus_neighbors(_t(xyz), _t(mask), mn, mx, k,
                                    chunk=128)
    np.testing.assert_array_equal(got.idx.numpy(), np.array(want.idx))
    np.testing.assert_array_equal(got.mask.numpy(), np.array(want.mask))
    assert got.mask.any() and not (
        got.idx == torch.arange(400, dtype=torch.int32)[:, None])[
            got.mask].any()


def test_voxel_majority_label():
    """Random labels over few voxels, a voxel with a planted tie (the
    lower class wins), padded points that must not vote, and overflow
    points (segment v_max) dropped."""
    rng = np.random.RandomState(4)
    n, v_max, c = 600, 40, 7
    labels = rng.randint(0, c, n).astype(np.int32)
    mask = rng.rand(n) > 0.1
    seg = rng.randint(0, v_max + 1, n).astype(np.int32)
    seg[:6] = 3
    labels[:6] = [5, 5, 2, 2, 6, 6]
    mask[:6] = True
    seg[6:][seg[6:] == 3] = 4                 # voxel 3: a three-way tie
    labels[6] = 1
    mask[6] = False
    seg[6] = 3                                # a padded point's vote
    want = np.array(jvox.voxel_majority_label(labels, mask, seg, v_max, c))
    got = tvox.voxel_majority_label(_t(labels), _t(mask), _t(seg), v_max,
                                    c).numpy()
    assert got.dtype == np.int32 and got.shape == (v_max,)
    np.testing.assert_array_equal(got, want)
    assert got[3] == 2


def test_average_downsample():
    rng = np.random.RandomState(5)
    xyz = rng.uniform(0, 3, (2048, 3)).astype(np.float32)
    feats = rng.randn(2048, 6).astype(np.float32)
    mask = rng.rand(2048) > 0.2
    for cap in (512, 64):                     # 64: voxels overflow the cap
        want = jhier.average_downsample(xyz, feats, mask, 0.25, 3.0, cap)
        got = thier.average_downsample(_t(xyz), _t(feats), _t(mask), 0.25,
                                       3.0, cap)
        np.testing.assert_array_equal(got[2].numpy(), np.array(want[2]))
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_allclose(g.numpy(), np.array(w), atol=1e-6)


def test_toy_two_class_batches():
    kw = dict(num_points=512, seed=3)
    want = list(jtoy.toy_batches(2, 2, kind="toy", **kw))
    got = list(ttoy.toy_batches(2, 2, kind="toy", **kw))
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], key)
    assert set(np.unique(got[0]["labels"])) <= {0, 1}
    b = ttoy.toy_two_class_block(np.random.RandomState(0), 300)
    w = jtoy.toy_two_class_block(np.random.RandomState(0), 300)
    for key in w:
        np.testing.assert_array_equal(b[key], w[key])
    # the default is JAX's ("toy"); rooms are asked for by name
    plain = next(ttoy.toy_batches(1, 1, num_points=256))
    np.testing.assert_array_equal(
        plain["xyz"], next(jtoy.toy_batches(1, 1, num_points=256))["xyz"])
    room = next(ttoy.toy_batches(1, 1, num_points=256, kind="room"))
    np.testing.assert_array_equal(
        room["xyz"], next(jtoy.toy_batches(1, 1, num_points=256,
                                           kind="room"))["xyz"])
    with pytest.raises(ValueError):
        next(ttoy.toy_batches(1, 1, kind="cube"))
