"""The windowed search's global selection and its wide overflow tier in the
port against the JAX package on CPU, where JAX's approximate selection is
exact: every band's windowed and overflow slots (slab-local indices, pool
positions, wide-tier indices, masks, ``to_neighborhood()``) and the shared
edge list equal, sxyz to 1e-6; the wide tier's gather and its vjp against
``jax.vjp`` of the JAX ``gather_neighbors``; the dispatch's and the recall
tool's global selection against JAX's.  Blocks stay near the origin (the
selection score cancels far from it)."""
import contextlib
import io
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudsegmentation_tpu.data import toy
from pointcloudsegmentation_tpu.ops import morton as jmorton
from pointcloudsegmentation_tpu.ops import neighbors as jnb
from pointcloudsegmentation_tpu.ops import search as jsearch
from pointcloudsegmentation_tpu_torch import verify_search_recall as vsr
from pointcloudsegmentation_tpu_torch.ops import neighbors as tnb
from pointcloudsegmentation_tpu_torch.ops import search as tsearch
from test_torch_window_dslab import _grad_magnitude, assert_sums_close

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
import verify_search_recall as jrecall  # noqa: E402

torch.set_num_threads(1)

# the flagship's stage-0 bands, radii scaled up so a block of 1024 points
# has full neighborhoods and out-of-slab neighbors; and tests/test_windowed
# .py's bands
FLAGSHIP_BANDS = ((0.0, 0.45, 32), (0.45, 0.6, 24), (0.3, 0.45, 16),
                  (0.0, 0.3, 16))
WINDOWED_BANDS = ((0.0, 0.4, 16), (0.4, 0.6, 12), (0.0, 0.25, 8))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(autouse=True)
def _no_env_override(monkeypatch):
    """The JAX search takes sel_mode from the environment where it is set."""
    monkeypatch.delenv("PCS_SEL_MODE", raising=False)


def _sorted_block(seed, n, dup=0, n_pad=0):
    rng = np.random.RandomState(seed)
    xyz = toy.synthetic_room_block(rng, n=n)["xyz"]
    if dup:   # exact duplicates: score ties broken by index
        xyz[n // 2:n // 2 + dup] = xyz[10]
    mask = np.ones(n, bool)
    if n_pad:
        mask[rng.choice(n, n_pad, replace=False)] = False
        xyz[~mask] = 0.0
    x, m, _ = jmorton.sort_block(xyz, mask, 0.0375, 3.0)
    return np.array(x), np.array(m)


def _both(xyz, mask, bands, **kw):
    jres = jsearch.windowed_multi_band_neighbors(
        jnp.asarray(xyz), jnp.asarray(mask), bands, return_sxyz=True, **kw)
    tres = tsearch.windowed_multi_band_neighbors(
        _t(xyz), _t(mask), bands, return_sxyz=True, **kw)
    return jres, tres


def _check_slots(jres, tres):
    assert len(jres) == len(tres)
    for j, t in zip(jres, tres):
        (jn, jsx), (tn, tsx) = j[:2], t[:2]
        assert tn.ov_window == jn.ov_window
        for f in ("lidx", "wmask", "ov_idx", "ov_mask"):
            np.testing.assert_array_equal(getattr(tn, f).numpy(),
                                          np.array(getattr(jn, f)), f)
        assert (tn.pool_idx is None) == (jn.pool_idx is None)
        if tn.pool_idx is not None:
            np.testing.assert_array_equal(tn.pool_idx.numpy(),
                                          np.array(jn.pool_idx))
        jg, tg = jn.to_neighborhood(), tn.to_neighborhood()
        np.testing.assert_array_equal(tg.idx.numpy(), np.array(jg.idx))
        np.testing.assert_array_equal(tg.mask.numpy(), np.array(jg.mask))
        np.testing.assert_allclose(tsx.numpy(), np.array(jsx), atol=1e-6,
                                   rtol=0)
        assert tn.wmask.any()


def _check_edges(jres, tres):
    _check_slots(jres, tres)
    je, te = jres[0][2], tres[0][2]
    assert all(t[2] is te for t in tres)
    for f in ("center", "nbr", "mask"):
        np.testing.assert_array_equal(getattr(te, f).numpy(),
                                      np.array(getattr(je, f)), f)
    for f in ("sxyz", "d2"):
        np.testing.assert_allclose(getattr(te, f).numpy(),
                                   np.array(getattr(je, f)), atol=1e-6,
                                   rtol=0)
    assert te.mask.any()


@pytest.mark.parametrize("n,bands,tile,pool,seed,dup,n_pad", [
    (1024, FLAGSHIP_BANDS, 256, 0, 0, 0, 0),
    (1024, FLAGSHIP_BANDS, 256, 256, 1, 24, 0),
    (2048, FLAGSHIP_BANDS, 256, 256, 2, 0, 100),
    (2048, FLAGSHIP_BANDS, 256, 0, 3, 0, 0),
    (1024, WINDOWED_BANDS, 128, 0, 4, 0, 0),
    (1024, WINDOWED_BANDS, 128, 256, 5, 0, 60),
])
def test_global_selection_slots(n, bands, tile, pool, seed, dup, n_pad):
    """Global selection with per-point overflow slots (pool 0) and with the
    tile-shared pool (256), at the flagship's level-0 bands (tile and
    window 256) and at tests/test_windowed.py's (tile and window 128)."""
    xyz, mask = _sorted_block(seed, n, dup, n_pad)
    jres, tres = _both(xyz, mask, bands, tile=tile, window=tile, cand_k=64,
                       ov_slots=8, chunk=1024, ov_pool_size=pool,
                       sel_mode="global")
    _check_slots(jres, tres)
    assert any(t.ov_mask.any() for t, _ in tres)   # the pool is reached


@pytest.mark.parametrize("n,bands,tile,pool", [
    (1024, FLAGSHIP_BANDS, 256, 0), (2048, FLAGSHIP_BANDS, 256, 256),
    (1024, WINDOWED_BANDS, 128, 256)])
def test_global_selection_edges(n, bands, tile, pool):
    """Global selection feeding the shared edge list: the pool plays no
    part, whatever ``ov_pool_size``."""
    xyz, mask = _sorted_block(6, n, n_pad=40)
    jres, tres = _both(xyz, mask, bands, tile=tile, window=tile, cand_k=64,
                       ov_slots=8, chunk=1024, ov_pool_size=pool,
                       sel_mode="global", ov_mode="edges", edge_ratio=3)
    _check_edges(jres, tres)


@pytest.fixture(scope="module")
def wide_tier():
    """The wide tier at 2048 points, tile and window 256, ov_window 512,
    per-point overflow slots, both sides."""
    xyz, mask = _sorted_block(7, 2048, n_pad=50)
    jres, tres = _both(xyz, mask, FLAGSHIP_BANDS, tile=256, window=256,
                       cand_k=64, ov_slots=8, chunk=1024, ov_window=512,
                       sel_mode="global")
    return xyz, mask, jres, tres


def test_wide_tier_slots(wide_tier):
    _, _, jres, tres = wide_tier
    _check_slots(jres, tres)
    for tn, _ in tres:
        assert tn.ov_window == 512 and tn.pool_idx is None
        # wide-tier slots are slab-local in [0, T + 2 * ov_window)
        assert int(tn.ov_idx.min()) >= 0
        assert int(tn.ov_idx.max()) < 256 + 2 * 512
    assert any(t.ov_mask.any() for t, _ in tres)


def test_wide_tier_edges():
    """Edges under the wide tier: the edge list's neighbors are the tier's
    slab-local indices made global (clipped into the block)."""
    xyz, mask = _sorted_block(8, 2048)
    jres, tres = _both(xyz, mask, FLAGSHIP_BANDS, tile=256, window=256,
                       cand_k=64, ov_slots=8, chunk=1024, ov_window=512,
                       sel_mode="global", ov_mode="edges", edge_ratio=3)
    _check_edges(jres, tres)


def test_wide_tier_gather_and_vjp(wide_tier):
    """``gather_neighbors`` on a wide-tier neighborhood (windowed slots,
    then the tier's slots through the window gather at window=ov_window)
    and its vjp against ``jax.vjp`` of the JAX gather, float32."""
    _, _, jres, tres = wide_tier
    (jn, _), (tn, _) = jres[0], tres[0]
    n = tn.lidx.shape[0]
    rng = np.random.RandomState(9)
    feats = rng.randn(n, 12).astype(np.float32)
    out, vjp = jax.vjp(lambda x: jnb.gather_neighbors(x, jn),
                       jnp.asarray(feats))
    cot = rng.randn(*out.shape).astype(np.float32)
    (want,) = vjp(jnp.asarray(cot))
    x = _t(feats).requires_grad_()
    y = tnb.gather_neighbors(x, tn)
    assert y.shape == out.shape == (n, tn.lidx.shape[1] + tn.ov_idx.shape[1],
                                    12)
    np.testing.assert_array_equal(y.detach().numpy(), np.array(out))
    y.backward(_t(cot))
    # the same slot terms summed in another order: within 1e-6 of each
    # element's |value| plus the magnitude of its terms
    assert_sums_close(x.grad.numpy(), np.array(want),
                      _grad_magnitude(tnb.gather_neighbors, x, tn, cot))


def test_selection_settings_are_validated():
    xyz, mask = _sorted_block(0, 1024)
    x, m = _t(xyz), _t(mask)
    bands = FLAGSHIP_BANDS[:1]
    with pytest.raises(ValueError, match="sel_mode"):
        tsearch.resolve_sel_mode("salb")
    with pytest.raises(ValueError, match="sel_mode"):
        tsearch.windowed_multi_band_neighbors(x, m, bands, sel_mode="salb")
    with pytest.raises(ValueError, match="sel_mode"):
        tsearch.band_neighbors_auto(x, m, bands, sorted=True,
                                    sel_mode="salb")
    with pytest.raises(ValueError, match="wide-tier"):
        tsearch.windowed_multi_band_neighbors(x, m, bands, sel_mode="slab",
                                              ov_window=512)
    for bad in (384, 128):    # not a multiple of the tile; under the window
        with pytest.raises(ValueError, match="ov_window"):
            tsearch.windowed_multi_band_neighbors(x, m, bands, ov_window=bad)
    assert tsearch.resolve_sel_mode("global") == "global"


@pytest.mark.parametrize("kw", [
    dict(sel_mode="global", win_cand_k=64, ov_pool_size=256),
    dict(sel_mode="global", ov_pool_size=0, ov_slots=4, cand_k=48),
    dict(sel_mode="slab", win_cand_k=48, ov_pool_size=256)])
def test_band_neighbors_auto_settings(kw):
    """The dispatch with JAX's full signature: each windowed setting
    reaches the search as it reaches JAX's."""
    xyz, mask = _sorted_block(10, 1024, n_pad=30)
    jres = jsearch.band_neighbors_auto(xyz, mask, FLAGSHIP_BANDS,
                                       return_sxyz=True, sorted=True, **kw)
    tres = tsearch.band_neighbors_auto(_t(xyz), _t(mask), FLAGSHIP_BANDS,
                                       return_sxyz=True, sorted=True, **kw)
    _check_slots(jres, tres)


@pytest.mark.parametrize("config", [("global", 64, 0, 256),
                                    ("global", 32, 384, 256),
                                    ("global", 64, 256, 512)])
def test_recall_global_triple_equals_jax(config):
    """``verify_search_recall``'s global triples at 2048 points: the recall
    of every band equals the JAX tool's."""
    sel_mode, ck, pool, window = config
    kw = dict(n=2048, cand_k=ck, seed=0, sel_mode=sel_mode,
              ov_pool_size=pool, window=window)
    got = vsr.windowed_band_recall(device="cpu", **kw)
    assert got == jrecall.windowed_band_recall(**kw)


def _printed(main, argv):
    """What ``main(argv)`` prints before it exits, and its exit code."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit) as e:
        main(argv)
    return buf.getvalue().splitlines(), e.value.code


def test_recall_grid_equals_jax(monkeypatch):
    """``--grid``, the selection study (global and slab at cand_k 64, 48
    and 32, pool 384), cut to 1024 points on both sides: the port's rows
    are the JAX tool's, line for line, and so is its verdict."""
    for mod, kw in ((vsr, dict(device="cpu")), (jrecall, {})):
        monkeypatch.setattr(mod, "band_recall",
                            partial(mod.band_recall, n=1024, **kw))
        monkeypatch.setattr(mod, "windowed_band_recall",
                            partial(mod.windowed_band_recall, n=1024, **kw))
    got, got_code = _printed(vsr.main, ["--grid", "--device", "cpu"])
    want, want_code = _printed(jrecall.main, ["--grid"])
    assert got == want and got_code == want_code
    assert sum("windowed[global" in line for line in got) == 3 * 2 * 3
