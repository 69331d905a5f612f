"""Parity of the port's neighbor search with the JAX package on CPU, where
JAX's approximate selection is exact: every band's global neighbor view must
match slot for slot, and sxyz to 1e-6."""
import jax
import numpy as np
import pytest
import torch

from pointcloudsegmentation_tpu.data import toy
from pointcloudsegmentation_tpu.ops import morton as jmorton
from pointcloudsegmentation_tpu.ops import search as jsearch
from pointcloudsegmentation_tpu_torch.ops import search as tsearch

torch.set_num_threads(1)

# the flagship's stage-0 bands (min_radius, max_radius, k), radii scaled up
# so a 1024-point block has full neighborhoods and out-of-slab neighbors
BANDS = ((0.0, 0.45, 32), (0.45, 0.6, 24), (0.3, 0.45, 16), (0.0, 0.3, 16))


def _sorted_block(seed, n, dup=0, n_pad=0):
    rng = np.random.RandomState(seed)
    xyz = toy.synthetic_room_block(rng, n=n)["xyz"]
    if dup:   # exact duplicates: distance ties broken by index
        xyz[n // 2:n // 2 + dup] = xyz[10]
        xyz[n // 3:n // 3 + dup] = xyz[n - 7]
    mask = np.ones(n, bool)
    if n_pad:
        mask[rng.choice(n, n_pad, replace=False)] = False
        xyz[~mask] = 0.0
    x, m, _ = jmorton.sort_block(xyz, mask, 0.0375, 3.0)
    return np.array(x), np.array(m)


def _check_bands(jres, tres, windowed):
    assert len(jres) == len(tres)
    for (jn, jsx), (tn, tsx) in zip(jres, tres):
        if windowed:
            jn, tn = jn.to_neighborhood(), tn.to_neighborhood()
        np.testing.assert_array_equal(np.array(tn.mask), np.array(jn.mask))
        np.testing.assert_array_equal(np.array(tn.idx), np.array(jn.idx))
        np.testing.assert_allclose(np.array(tsx), np.array(jsx),
                                   atol=1e-6, rtol=0)
        assert np.array(tn.mask).any()


@pytest.mark.parametrize("seed,dup,n_pad", [(0, 0, 0), (1, 24, 0),
                                            (2, 0, 100)])
def test_windowed_multi_band_neighbors(seed, dup, n_pad):
    n, tile, pool = 1024, 256, 256
    xyz, mask = _sorted_block(seed, n, dup, n_pad)
    ck = jsearch.effective_win_cand_k(32, 64, BANDS, n)
    jres = jsearch.windowed_multi_band_neighbors(
        xyz, mask, BANDS, tile=tile, window=tile, cand_k=ck, ov_slots=8,
        chunk=1024, return_sxyz=True, ov_pool_size=pool, sel_mode="slab")
    tres = tsearch.windowed_multi_band_neighbors(
        torch.from_numpy(xyz), torch.from_numpy(mask), BANDS, tile=tile,
        window=tile, cand_k=ck, ov_slots=8, chunk=1024, ov_pool_size=pool,
        return_sxyz=True)
    _check_bands(jres, tres, windowed=True)
    # the pool is reached: some overflow slot is valid
    assert any(np.array(t.ov_mask).any() for t, _ in tres)
    np.testing.assert_array_equal(np.array(tres[0][0].pool_idx),
                                  np.array(jres[0][0].pool_idx))


@pytest.mark.parametrize("seed,dup", [(0, 0), (1, 16)])
def test_multi_band_neighbors(seed, dup):
    n = 256
    xyz, mask = _sorted_block(seed, n, dup, n_pad=20)
    jres = jsearch.multi_band_neighbors(xyz, mask, BANDS, cand_k=64,
                                        chunk=256, return_sxyz=True)
    tres = tsearch.multi_band_neighbors(
        torch.from_numpy(xyz), torch.from_numpy(mask), BANDS, cand_k=64,
        chunk=256, return_sxyz=True)
    _check_bands(jres, tres, windowed=False)


def test_topk_smallest_breaks_ties_by_index():
    s = torch.tensor([[3.0, 1.0, 1.0, -2.0, 1.0, 0.0, -0.5]])
    v, i = tsearch._topk_smallest(s, 5)
    assert i.tolist() == [[3, 6, 5, 1, 2]]
    assert v.tolist() == [[-2.0, -0.5, 0.0, 1.0, 1.0]]
    jv, ji = jax.lax.top_k(-np.asarray(s), 5)
    np.testing.assert_array_equal(np.array(ji), i.numpy())


def test_sqnorm3_matches_fused_reduction():
    rng = np.random.RandomState(0)
    v = rng.randn(4000, 3).astype(np.float32)
    want = jax.jit(lambda a: (a * a).sum(-1))(v)
    np.testing.assert_array_equal(
        tsearch.sqnorm3(torch.from_numpy(v)).numpy(), np.array(want))
