"""Parity of the port's geometry ops (Morton order, segments, voxelization,
pyramid) with the JAX package on the same numpy inputs.  Integers must match
exactly; floats to 1e-6 (float32, summation order may differ)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudsegmentation_tpu.data import toy
from pointcloudsegmentation_tpu.ops import hierarchy as jhier
from pointcloudsegmentation_tpu.ops import morton as jmorton
from pointcloudsegmentation_tpu.ops import segments as jseg
from pointcloudsegmentation_tpu.ops import voxelize as jvox
from pointcloudsegmentation_tpu_torch.ops import hierarchy as thier
from pointcloudsegmentation_tpu_torch.ops import morton as tmorton
from pointcloudsegmentation_tpu_torch.ops import segments as tseg
from pointcloudsegmentation_tpu_torch.ops import voxelize as tvox

torch.set_num_threads(1)
ATOL = 1e-6


def _block(seed, n=1024, n_pad=64):
    """A synthetic S3DIS-shaped block with ``n_pad`` padded rows."""
    rng = np.random.RandomState(seed)
    b = toy.synthetic_room_block(rng, n=n)
    mask = np.ones(n, bool)
    mask[n - n_pad:] = False
    xyz = b["xyz"].copy()
    xyz[~mask] = 0.0
    return xyz, b["feats"], mask


def _np(x):
    return np.array(x.cpu() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("seed", [0, 1])
def test_morton_order_and_sort_block(seed):
    xyz, feats, mask = _block(seed)
    cell, bs = 0.15 / 4.0, 3.0
    jo = jax.jit(jmorton.morton_order, static_argnums=(2, 3))(
        xyz, mask, cell, bs)
    to = tmorton.morton_order(torch.from_numpy(xyz), torch.from_numpy(mask),
                              cell, bs)
    np.testing.assert_array_equal(_np(to), _np(jo))
    txyz, tmask, _, tfeats = tmorton.sort_block(
        torch.from_numpy(xyz), torch.from_numpy(mask), cell, bs,
        torch.from_numpy(feats))
    np.testing.assert_array_equal(_np(txyz), xyz[_np(jo)])
    np.testing.assert_array_equal(_np(tfeats), feats[_np(jo)])
    inv = tmorton.inverse_permutation(to)
    np.testing.assert_array_equal(_np(inv),
                                  _np(jmorton.inverse_permutation(jo)))
    np.testing.assert_array_equal(_np(txyz[inv]), xyz)


def test_morton_code_matches():
    rng = np.random.RandomState(3)
    c = rng.randint(0, 1024, (500, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        _np(tmorton.morton_code(torch.from_numpy(c))),
        _np(jmorton.morton_code(jnp.asarray(c))))


@pytest.mark.parametrize("seed", [0, 1])
def test_segment_reductions(seed):
    rng = np.random.RandomState(seed)
    n, v, f = 300, 40, 5
    seg = rng.randint(0, v + 1, n).astype(np.int32)   # v = overflow slot
    seg[seg == 7] = 8                                  # segment 7 empty
    data = rng.randn(n, f).astype(np.float32)
    ts, td = torch.from_numpy(seg), torch.from_numpy(data)
    for jf, tf in [(jseg.segment_sum, tseg.segment_sum),
                   (jseg.segment_mean, tseg.segment_mean),
                   (jseg.segment_max, tseg.segment_max)]:
        want = _np(jax.jit(jf, static_argnums=2)(data, seg, v))
        got = _np(tf(td, ts, v))
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
        assert np.all(got[7] == 0.0)
    np.testing.assert_array_equal(_np(tseg.segment_count(ts, v)),
                                  _np(jseg.segment_count(seg, v)))
    vf = rng.randn(v, f).astype(np.float32)
    np.testing.assert_array_equal(
        _np(tseg.segment_unpool(torch.from_numpy(vf), ts)),
        _np(jseg.segment_unpool(vf, seg)))


@pytest.mark.parametrize("voxel,cap", [(0.15, 4096), (0.45, 64)])
def test_voxelize(voxel, cap):
    xyz, _, mask = _block(2)
    want = jax.jit(jvox.voxelize, static_argnums=(2, 3, 4))(
        xyz, mask, voxel, 3.0, cap)
    got = tvox.voxelize(torch.from_numpy(xyz), torch.from_numpy(mask),
                        voxel, 3.0, cap)
    np.testing.assert_array_equal(_np(got.seg), _np(want.seg))
    np.testing.assert_array_equal(_np(got.counts), _np(want.counts))
    np.testing.assert_array_equal(_np(got.mask), _np(want.mask))
    np.testing.assert_allclose(_np(got.centers), _np(want.centers),
                               atol=ATOL, rtol=0)
    if cap == 64:   # the cap overflows: extra voxels go to the overflow slot
        assert (_np(got.seg) == cap).sum() > (~mask).sum()


@pytest.mark.parametrize("seed", [0, 1])
def test_pyramid_and_pools(seed):
    xyz, feats, mask = _block(seed)
    cell = 0.15 / 4.0
    jx, jm, _, jf = jax.jit(jmorton.sort_block, static_argnums=(2, 3))(
        xyz, mask, cell, 3.0, feats)
    jx, jm, jf = _np(jx), _np(jm), _np(jf)
    jp = jax.jit(jhier.build_pyramid, static_argnums=(2, 3, 4, 5))(
        jx, jm, (0.15, 0.45), (512, 128), 3.0, True)
    tp = thier.build_pyramid(torch.from_numpy(jx), torch.from_numpy(jm),
                             (0.15, 0.45), (512, 128), 3.0, True)
    assert tp.num_levels == 3 and tp.level_sorted(0) and tp.level_sorted(2)
    for a, b in zip(tp.levels, jp.levels):
        np.testing.assert_array_equal(_np(a.mask), _np(b.mask))
        np.testing.assert_allclose(_np(a.xyz), _np(b.xyz), atol=ATOL, rtol=0)
    for a, b in zip(tp.seg, jp.seg):
        np.testing.assert_array_equal(_np(a), _np(b))
    for a, b in zip(tp.dxyz, jp.dxyz):
        np.testing.assert_allclose(_np(a), _np(b), atol=ATOL, rtol=0)
    tf = torch.from_numpy(jf)
    for lvl in (0,):
        np.testing.assert_allclose(
            _np(thier.pool_max(tf, tp, lvl)), _np(jhier.pool_max(jf, jp, lvl)),
            atol=ATOL, rtol=0)
        np.testing.assert_allclose(
            _np(thier.pool_avg(tf, tp, lvl)), _np(jhier.pool_avg(jf, jp, lvl)),
            atol=ATOL, rtol=0)
    v1 = np.random.RandomState(seed).randn(512, 4).astype(np.float32)
    np.testing.assert_array_equal(
        _np(thier.unpool(torch.from_numpy(v1), tp, 0)),
        _np(jhier.unpool(v1, jp, 0)))
