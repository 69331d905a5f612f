"""The per-point overflow search of the ECD and PGNet families
(``ov_pool_size=0``) and the neighbor ops they use, against the JAX
package on the CPU, where JAX's approximate selection is exact.

The search runs on Morton-sorted 2048-point toy blocks with ``ECDStage``'s
band (0, 0.15, 16) and ``PointNet2Baseline``'s two stage-0 bands, candidate
pool 64: every slot's index and mask must be equal (0 differences) and sxyz
within 1e-6.  The neighbor ops are held on the same windowed neighborhood
and on a plain one: gathers and masks exactly, reductions to 1e-6.
Last, ``chip_smoke.ecd_gathers``, which the card's launch counts are held
to, against the gathers a CPU forward of each key records."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudsegmentation_tpu.data import toy
from pointcloudsegmentation_tpu.ops import morton as jmorton
from pointcloudsegmentation_tpu.ops import neighbors as jnb
from pointcloudsegmentation_tpu.ops import search as jsearch
from pointcloudsegmentation_tpu.ops.types import Neighborhood as JNbr
from pointcloudsegmentation_tpu_torch.ops import neighbors as tnb
from pointcloudsegmentation_tpu_torch.ops import search as tsearch
from pointcloudsegmentation_tpu_torch.ops.types import Neighborhood as TNbr
from pointcloudsegmentation_tpu_torch.ops.types import WindowedNeighborhood

torch.set_num_threads(1)

N = 2048
ECD_BANDS = ((0.0, 0.15, 16),)
PN2_BANDS = ((0.0, 0.15, 32), (0.0, 0.1, 16))
CAND_K = 64


def _sorted_block(seed, n=N, n_pad=0):
    rng = np.random.RandomState(seed)
    xyz = toy.synthetic_room_block(rng, n=n)["xyz"]
    mask = np.ones(n, bool)
    if n_pad:
        mask[rng.choice(n, n_pad, replace=False)] = False
        xyz[~mask] = 0.0
    x, m, _ = jmorton.sort_block(xyz, mask, 0.0375, 3.0)
    return np.array(x), np.array(m)


def _t(a):
    return torch.from_numpy(np.array(a))


def _check_windowed(jres, tres):
    """Slot for slot: the windowed tier's slab-local indices and masks, the
    per-point overflow tier's global indices and masks, and sxyz."""
    assert len(jres) == len(tres)
    for (jn, jsx), (tn, tsx) in zip(jres, tres):
        assert isinstance(tn, WindowedNeighborhood)
        assert jn.pool_idx is None and tn.pool_idx is None
        for field in ("lidx", "wmask", "ov_idx", "ov_mask"):
            np.testing.assert_array_equal(getattr(tn, field).numpy(),
                                          np.array(getattr(jn, field)),
                                          err_msg=field)
        np.testing.assert_array_equal(tn.global_idx.numpy(),
                                      np.array(jn.global_idx))
        np.testing.assert_array_equal(tn.counts().numpy(),
                                      np.array(jn.counts()))
        np.testing.assert_allclose(tsx.numpy(), np.array(jsx), atol=1e-6,
                                   rtol=0)
    # both tiers are reached
    assert all(tn.wmask.any() for tn, _ in tres)
    assert any(tn.ov_mask.any() for tn, _ in tres)


@pytest.mark.parametrize("bands,seed,n_pad", [(ECD_BANDS, 0, 0),
                                              (ECD_BANDS, 1, 150),
                                              (PN2_BANDS, 2, 0),
                                              (PN2_BANDS, 3, 150)])
def test_windowed_search_per_point_overflow(bands, seed, n_pad):
    xyz, mask = _sorted_block(seed, n_pad=n_pad)
    ck = jsearch.effective_win_cand_k(None, CAND_K, bands, N)
    jres = jsearch.windowed_multi_band_neighbors(
        xyz, mask, bands, tile=256, window=256, cand_k=ck, ov_slots=8,
        chunk=1024, return_sxyz=True, ov_pool_size=0, sel_mode="slab")
    tres = tsearch.windowed_multi_band_neighbors(
        _t(xyz), _t(mask), bands, tile=256, window=256, cand_k=ck,
        ov_slots=8, chunk=1024, ov_pool_size=0, return_sxyz=True,
        sel_mode="slab")
    _check_windowed(jres, tres)
    # invalid overflow slots hold the point's own index
    for tn, _ in tres:
        row = torch.arange(N, dtype=torch.int32)[:, None].expand_as(
            tn.ov_idx)
        assert torch.equal(tn.ov_idx[~tn.ov_mask], row[~tn.ov_mask])


@pytest.mark.parametrize("bands", [ECD_BANDS, PN2_BANDS])
@pytest.mark.parametrize("n,is_sorted", [(N, True), (N, False),
                                         (512, True)])
def test_band_neighbors_auto(bands, n, is_sorted):
    """The dispatch: windowed at 2048 sorted points, the global search on
    unsorted points and below 4 tiles, each as JAX chooses and computes
    it."""
    xyz, mask = _sorted_block(7, n=n, n_pad=40)
    kw = dict(cand_k=CAND_K, return_sxyz=True, sorted=is_sorted)
    jres = jsearch.band_neighbors_auto(xyz, mask, bands, **kw)
    tres = tsearch.band_neighbors_auto(_t(xyz), _t(mask), bands, **kw)
    windowed = is_sorted and n == N
    assert all(isinstance(tn, WindowedNeighborhood) == windowed
               for tn, _ in tres)
    if windowed:
        _check_windowed(jres, tres)
        return
    for (jn, jsx), (tn, tsx) in zip(jres, tres):
        np.testing.assert_array_equal(tn.idx.numpy(), np.array(jn.idx))
        np.testing.assert_array_equal(tn.mask.numpy(), np.array(jn.mask))
        np.testing.assert_allclose(tsx.numpy(), np.array(jsx), atol=1e-6,
                                   rtol=0)


@pytest.fixture(scope="module")
def neighborhoods():
    """(JAX, port) pairs of the per-point windowed neighborhood at 2048
    points and of its plain global view, with 12-wide random features."""
    xyz, mask = _sorted_block(4, n_pad=100)
    (jn, _), = jsearch.windowed_multi_band_neighbors(
        xyz, mask, ECD_BANDS, tile=256, window=256, cand_k=CAND_K,
        ov_slots=8, chunk=1024, return_sxyz=True, ov_pool_size=0,
        sel_mode="slab")
    (tn, _), = tsearch.windowed_multi_band_neighbors(
        _t(xyz), _t(mask), ECD_BANDS, tile=256, window=256, cand_k=CAND_K,
        ov_slots=8, chunk=1024, ov_pool_size=0, return_sxyz=True,
        sel_mode="slab")
    jplain, tplain = jn.to_neighborhood(), tn.to_neighborhood()
    assert isinstance(tplain, TNbr)
    feats = np.random.RandomState(5).randn(N, 12).astype(np.float32)
    return dict(windowed=(jn, tn), plain=(jplain, tplain), feats=feats)


@pytest.mark.parametrize("kind", ["windowed", "plain"])
def test_neighbor_ops(neighborhoods, kind):
    jn, tn = neighborhoods[kind]
    f = neighborhoods["feats"]
    tf = _t(f)
    np.testing.assert_array_equal(tnb.gather_neighbors(tf, tn).numpy(),
                                  np.array(jnb.gather_neighbors(f, jn)))
    diff = tnb.neighbor_diff(tf, tn)
    np.testing.assert_array_equal(diff.numpy(),
                                  np.array(jnb.neighbor_diff(f, jn)))
    # invalid slots self-pad: their difference is exactly zero
    assert not diff[~tn.mask].any()
    edge = np.array(jnb.neighbor_diff(f, jn)) * 3.0 + 0.5
    te = _t(edge)
    for name in ("masked_max", "masked_sum", "masked_mean",
                 "masked_mean_eps"):
        np.testing.assert_allclose(
            getattr(tnb, name)(te, tn).numpy(),
            np.array(getattr(jnb, name)(edge, jn)), rtol=1e-6, atol=1e-6,
            err_msg=name)
    np.testing.assert_array_equal(tn.counts().numpy(),
                                  np.array(jn.counts()))


def test_masked_max_of_a_point_without_neighbors():
    """A point with no valid slot reduces to 0 under masked_max and the
    means, as in JAX."""
    idx = np.array([[0, 1], [1, 1], [2, 0]], np.int32)
    mask = np.array([[True, True], [False, False], [True, False]])
    edge = np.random.RandomState(0).randn(3, 2, 4).astype(np.float32)
    jn, tn = JNbr(idx, mask), TNbr(_t(idx), _t(mask))
    for name in ("masked_max", "masked_mean", "masked_mean_eps"):
        got = getattr(tnb, name)(_t(edge), tn).numpy()
        np.testing.assert_allclose(got, np.array(getattr(jnb, name)(edge,
                                                                    jn)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
        assert not got[1].any()


def test_eliminate_center_and_concat_non_center(neighborhoods):
    jn, tn = neighborhoods["plain"]
    f = neighborhoods["feats"]
    jnc = jnb.eliminate_center(jn)
    tnc = tnb.eliminate_center(tn)
    np.testing.assert_array_equal(tnc.idx.numpy(), np.array(jnc.idx))
    np.testing.assert_array_equal(tnc.mask.numpy(), np.array(jnc.mask))
    # the search's plain view holds self-edges, and they go
    assert (tn.mask & ~tnc.mask).any()
    jcat, _ = jnb.concat_non_center(f, jn)
    tcat, tnc2 = tnb.concat_non_center(_t(f), tn)
    np.testing.assert_array_equal(tcat.numpy(), np.array(jcat))
    assert torch.equal(tnc2.mask, tnc.mask)


def test_per_point_overflow_gather_gradient(neighborhoods):
    """The windowed gather's backward (the slab-gradient sums and their
    overlap-add) plus the overflow rows' index accumulation give the JAX
    gather's gradient, to 1e-5."""
    jn, tn = neighborhoods["windowed"]
    f = neighborhoods["feats"]
    w = np.random.RandomState(6).randn(N, tn.mask.shape[1], 12).astype(
        np.float32)
    want = jax.grad(lambda x: jnp.sum(jnb.gather_neighbors(x, jn) * w))(f)
    tf = _t(f).requires_grad_(True)
    (tnb.gather_neighbors(tf, tn) * _t(w)).sum().backward()
    np.testing.assert_allclose(tf.grad.numpy(), np.array(want), rtol=1e-5,
                               atol=1e-5)


def _chip_smoke():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("key", ["ecd_scannet", "ecd_s3dis", "pgnet_v3",
                                 "pgnet_v4", "pgnet_v5", "pgnet_v6",
                                 "pgnet_v7", "pgnet_v8", "pointnet2_s3dis"])
def test_chip_smoke_counts_every_window_gather(key, monkeypatch):
    """``chip_smoke.ecd_gathers``, which phase 11 holds the card's launch
    counts to, names every windowed gather a bf16 forward makes, in order,
    with its rows, slots, width and dtype (recorded from the plain version
    on the CPU at 1024 points, levels 0 and 1 windowed)."""
    from pointcloudsegmentation_tpu_torch import config as tconfig
    from pointcloudsegmentation_tpu_torch.kernels import window_gather as wg
    from pointcloudsegmentation_tpu_torch.train.model_zoo import build_model

    cs = _chip_smoke()
    scannet = key == "ecd_scannet"
    cfg = tconfig.CONFIGS["scannet" if scannet else "s3dis"](
        model=key, data_num_points=1024, data_caps=(1024, 256))
    model = build_model(cfg, torch.Generator().manual_seed(0), "cpu")
    b = next(toy.toy_batches(1, 1, 1024, kind="room",
                             num_classes=21 if scannet else 13,
                             feat_dim=cfg.data.feat_dim))
    seen = []
    plain = wg.gather_fwd_reference

    def record(feats, lidx, window, tile):
        seen.append((feats.shape[0], lidx.shape[1], feats.shape[1],
                     feats.dtype))
        return plain(feats, lidx, window, tile)

    monkeypatch.setattr(wg, "gather_fwd_reference", record)
    with torch.no_grad():
        model(*(_t(b[k][0]) for k in ("xyz", "feats", "mask")))
    sizes = (1024, 1024, 256)
    want = [(sizes[lvl], k, f, dt)
            for _, lvl, k, f, dt, _ in cs.ecd_gathers(model, cfg)]
    assert seen == want
    assert any(dt == torch.bfloat16 for *_, dt in seen)
