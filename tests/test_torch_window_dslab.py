"""The slab-gradient kernel's plain version against the JAX Pallas kernel
(interpret mode on CPU), and the port's differentiable windowed gather
(``WindowGather``) against ``jax.vjp`` of the JAX gathers, forward and
backward, on the same numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_window_gather import windowed_nbr  # noqa: F401 (fixture)

from pointcloudsegmentation_tpu.ops import neighbors as jnb
from pointcloudsegmentation_tpu.ops.pallas import dslab_bwd as pallas_dslab
from pointcloudsegmentation_tpu_torch.kernels import window_gather as wg
from pointcloudsegmentation_tpu_torch.ops import neighbors as tnb
from pointcloudsegmentation_tpu_torch.ops.types import WindowedNeighborhood

torch.set_num_threads(1)

N, T, W = 512, 128, 128
S = T + 2 * W


def assert_sums_close(got, want, mag, tol=1e-6):
    """|got - want| <= tol * (|want| + mag), elementwise: rtol = atol =
    ``tol`` (tests/test_pallas.py's dslab tolerance), with the absolute
    part scaled by ``mag``, each element's sum of the magnitudes of its
    terms.  The two sides add the same terms in another order, and a
    reordered float32 sum differs by up to a few ulps of its largest
    partial sum, which ``mag`` bounds; a bfloat16 result still has to
    match exactly, since one bfloat16 ulp is far larger."""
    got, want, mag = (np.asarray(a, np.float64) for a in (got, want, mag))
    err = np.abs(got - want)
    bound = tol * (np.abs(want) + mag)
    assert (err <= bound).all(), \
        f"{int((err > bound).sum())} elements off; worst err/bound " \
        f"{(err / np.maximum(bound, 1e-30)).max():.3g}"


def _lidx(rng, k, out_of_range=True):
    """Random slab indices with the slab's first and last rows, a row read
    by many slots, and (optionally) indices outside [0, S) that must add
    nothing."""
    lidx = rng.randint(0, S, (N, k)).astype(np.int32)
    lidx[:, 0] = 0
    lidx[:, 1] = S - 1
    lidx[::3, 2] = 7                         # one row read many times
    if out_of_range:
        lidx[::5, 3] = -1
        lidx[::7, 3] = S
    return lidx


@pytest.mark.parametrize("f,k,dtype", [(64, 8, "bfloat16"),
                                       (96, 6, "bfloat16"),
                                       (16, 12, "float32"),
                                       (8, 32, "float32"),
                                       # the flagship's widths
                                       (96, 24, "bfloat16"),
                                       (96, 32, "bfloat16"),
                                       (128, 24, "bfloat16"),
                                       (128, 32, "bfloat16"),
                                       (4, 32, "float32")])
def test_reference_matches_pallas_dslab(f, k, dtype):
    rng = np.random.RandomState(f * k)
    lidx = _lidx(rng, k)
    g = rng.randn(N, k, f).astype(np.float32)
    jg = jnp.asarray(g).astype(getattr(jnp, dtype))
    want = np.array(pallas_dslab(jg, jnp.asarray(lidx), W, T)
                    .astype(jnp.float32))
    tg = torch.from_numpy(g).to(getattr(torch, dtype))
    tl = torch.from_numpy(lidx)
    got = wg.dslab_bwd_reference(tg, tl, W, T)
    assert got.dtype == tg.dtype and got.shape == (N // T, S, f)
    mag = wg.dslab_bwd_reference(tg.float().abs(), tl, W, T)
    assert_sums_close(got.float().numpy(), want, mag.numpy())
    # on a CPU tensor the wrapper runs the plain version, launches nothing
    before = wg.dslab_bwd.launches
    assert torch.equal(wg.dslab_bwd(tg, tl, W, T), got)
    assert wg.dslab_bwd.launches == before


@pytest.mark.parametrize("f,k,dtype", [(64, 8, "bfloat16"),
                                       (12, 8, "float32")])
def test_reference_matches_pallas_dslab_wide_window(f, k, dtype):
    """The wide overflow tier's backward: window 512 over tiles of 256 (a
    slab of 1280 rows, more rows than the level-0 slab's 768), its map
    against numpy's stable argsort and its sums against the Pallas
    kernel."""
    n, t, w = 1024, 256, 512
    s = t + 2 * w
    rng = np.random.RandomState(f + k)
    lidx = rng.randint(0, s, (n, k)).astype(np.int32)
    lidx[:, 0] = 0
    lidx[:, 1] = s - 1
    lidx[::3, 2] = 700                       # one row read many times
    lidx[::5, 3] = -1                        # outside the slab: adds nothing
    lidx[::7, 3] = s
    g = rng.randn(n, k, f).astype(np.float32)
    jg = jnp.asarray(g).astype(getattr(jnp, dtype))
    want = np.array(pallas_dslab(jg, jnp.asarray(lidx), w, t)
                    .astype(jnp.float32))
    tg = torch.from_numpy(g).to(getattr(torch, dtype))
    tl = torch.from_numpy(lidx)
    got = wg.dslab_bwd_reference(tg, tl, w, t)
    assert got.shape == (n // t, s, f)
    mag = wg.dslab_bwd_reference(tg.float().abs(), tl, w, t)
    assert_sums_close(got.float().numpy(), want, mag.numpy())
    start, order = wg.dslab_map_reference(tl, w, t)
    nstart, norders = _numpy_map(lidx, w, t)
    np.testing.assert_array_equal(start.numpy(), nstart)
    for i, no in enumerate(norders):
        np.testing.assert_array_equal(order[i, :len(no)].numpy(), no)


def _numpy_map(lidx, window, tile):
    """(start, order) from numpy's stable argsort of each tile's slots by
    slab row, indices outside [0, S) dropped: the in-range prefix of the
    map and the bucket starts."""
    s = tile + 2 * window
    nt = lidx.shape[0] // tile
    rows = lidx.reshape(nt, -1)
    starts, orders = [], []
    for r in rows:
        keep = np.flatnonzero((r >= 0) & (r < s))
        orders.append(keep[np.argsort(r[keep], kind="stable")])
        counts = np.bincount(r[keep], minlength=s)
        starts.append(np.concatenate([[0], np.cumsum(counts)]))
    return np.stack(starts), orders


@pytest.mark.parametrize("k,out_of_range", [(8, True), (32, True),
                                            (24, False)])
def test_dslab_map_reference_matches_numpy(k, out_of_range):
    """The inverse map's plain version: per tile, the slots of each slab
    row in ascending order (numpy's stable argsort by row), the slots that
    read outside the slab after start[S], ascending."""
    rng = np.random.RandomState(k)
    lidx = _lidx(rng, k, out_of_range)
    start, order = wg.dslab_map_reference(torch.from_numpy(lidx), W, T)
    assert start.dtype == order.dtype == torch.int32
    assert start.shape == (N // T, S + 1) and order.shape == (N // T, T * k)
    want_start, want_order = _numpy_map(lidx, W, T)
    np.testing.assert_array_equal(start.numpy(), want_start)
    rows = lidx.reshape(N // T, -1)
    for t in range(N // T):
        inside = int(start[t, S])
        np.testing.assert_array_equal(order[t, :inside].numpy(), want_order[t])
        rest = order[t, inside:].numpy()
        np.testing.assert_array_equal(
            rest, np.flatnonzero((rows[t] < 0) | (rows[t] >= S)))
    # the wrapper runs the plain version on a CPU tensor, launches nothing
    before = wg.dslab_map.launches
    got = wg.dslab_map(torch.from_numpy(lidx), W, T)
    assert torch.equal(got[0], start) and torch.equal(got[1], order)
    assert wg.dslab_map.launches == before


def test_dslab_map_gives_the_plain_sums():
    """Summing each bucket's g rows in the map's order gives the plain
    version's slab gradient exactly, in float32 and bfloat16: the sum
    kernel's contract."""
    rng = np.random.RandomState(4)
    lidx = _lidx(rng, 16)
    start, order = wg.dslab_map_reference(torch.from_numpy(lidx), W, T)
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.from_numpy(rng.randn(N, 16, 8).astype(np.float32)).to(dtype)
        gt = g.reshape(N // T, T * 16, 8).float()
        want = wg.dslab_bwd_reference(g, torch.from_numpy(lidx), W, T)
        got = torch.zeros(N // T, S, 8)
        for t in range(N // T):
            for r in range(S):
                acc = torch.zeros(8)
                for i in order[t, start[t, r]:start[t, r + 1]].tolist():
                    acc = acc + gt[t, i]
                got[t, r] = acc
        assert torch.equal(got.to(dtype), want)


def test_dslab_bwd_rejects_bad_input():
    g = torch.zeros(N, 4, 8)
    li = torch.zeros(N, 4, dtype=torch.int32)
    with pytest.raises(ValueError):
        wg.dslab_bwd(g[:N - 1], li[:N - 1], W, T)      # N % T != 0
    with pytest.raises(ValueError):
        wg.dslab_bwd(g, li[:, :3], W, T)               # K mismatch
    with pytest.raises(TypeError):
        wg.dslab_bwd(g, li.long(), W, T)
    with pytest.raises(RuntimeError):
        wg.dslab_bwd(g.requires_grad_(), li, W, T)     # no double backward


@pytest.mark.parametrize("pallas", ["0", "1"])
def test_window_gather_vjp_matches_jax(pallas, monkeypatch):
    """WindowGather against jax.vjp of the JAX windowed gather, with the
    JAX backward as its XLA one-hot einsum and as the Pallas kernel."""
    monkeypatch.setenv("PCS_PALLAS_GATHER", pallas)
    rng = np.random.RandomState(3)
    lidx = _lidx(rng, 8, out_of_range=False)
    feats = rng.randn(N, 24).astype(np.float32)
    cot = rng.randn(N, 8, 24).astype(np.float32)
    jwn = jnb.WindowedNeighborhood(
        lidx=jnp.asarray(lidx), wmask=jnp.ones((N, 8), bool), window=W,
        tile=T, ov_idx=jnp.zeros((N, 0), jnp.int32),
        ov_mask=jnp.zeros((N, 0), bool))
    out, vjp = jax.vjp(lambda x: jnb.windowed_gather(x, jwn), feats)
    (want,) = vjp(jnp.asarray(cot))

    twn = WindowedNeighborhood(
        lidx=torch.from_numpy(lidx), wmask=torch.ones(N, 8, dtype=bool),
        ov_idx=torch.zeros(N, 0, dtype=torch.int32),
        ov_mask=torch.zeros(N, 0, dtype=bool), window=W, tile=T)
    x = torch.from_numpy(feats).requires_grad_()
    y = tnb.windowed_gather(x, twn)
    # slab rows past the block's ends: JAX's CPU path reads a clipped row,
    # the port zeros; neither passes a gradient there
    row = lidx + ((np.arange(N) // T) * T - W)[:, None]
    inside = (row >= 0) & (row < N)
    assert (~inside).any()
    np.testing.assert_array_equal(y.detach().numpy()[inside],
                                  np.array(out)[inside])
    assert not y.detach().numpy()[~inside].any()
    y.backward(torch.from_numpy(cot))
    assert_sums_close(x.grad.numpy(), np.array(want),
                      _grad_magnitude(tnb.windowed_gather, x, twn, cot))


def _grad_magnitude(gather, x, nbr, cot):
    """Per feature element, the sum of |cot| over the slots that read it:
    the gather's adjoint applied to |cot|."""
    x = x.detach().clone().requires_grad_()
    gather(x, nbr).backward(torch.from_numpy(np.abs(cot)))
    return x.grad.numpy()


@pytest.mark.parametrize("which", ["windowed_gather", "gather_neighbors"])
def test_pooled_gather_grad_matches_jax(windowed_nbr, which):  # noqa: F811
    """Forward and feature gradient of the pooled neighborhood gathers (the
    windowed slots plus the tile-shared overflow pool) against jax.vjp, on
    the search fixture of test_torch_window_gather.py."""
    jwn = windowed_nbr
    assert np.array(jwn.ov_mask).any()
    twn = WindowedNeighborhood(
        lidx=torch.from_numpy(np.array(jwn.lidx)),
        wmask=torch.from_numpy(np.array(jwn.wmask)),
        ov_idx=torch.from_numpy(np.array(jwn.ov_idx)),
        ov_mask=torch.from_numpy(np.array(jwn.ov_mask)),
        window=jwn.window, tile=jwn.tile,
        pool_idx=torch.from_numpy(np.array(jwn.pool_idx)))
    rng = np.random.RandomState(11)
    feats = rng.randn(1024, 24).astype(np.float32)
    out, vjp = jax.vjp(lambda x: getattr(jnb, which)(x, jwn), feats)
    cot = rng.randn(*out.shape).astype(np.float32)
    (want,) = vjp(jnp.asarray(cot))

    x = torch.from_numpy(feats).requires_grad_()
    y = getattr(tnb, which)(x, twn)
    np.testing.assert_array_equal(y.detach().numpy(), np.array(out))
    y.backward(torch.from_numpy(cot))
    assert_sums_close(x.grad.numpy(), np.array(want),
                      _grad_magnitude(getattr(tnb, which), x, twn, cot))


def test_overlap_add_order_in_bf16():
    """The overlap-add runs in g's dtype, chunk j = 0, 1, 2 in turn, as the
    JAX backward adds them."""
    rng = np.random.RandomState(2)
    dslab = rng.randn(N // T, S, 8).astype(np.float32)
    jd = jnp.asarray(dslab).astype(jnp.bfloat16)
    dpad = jnp.zeros((N + 2 * W, 8), jnp.bfloat16)
    for j in range(S // T):
        chunk = jd[:, j * T:(j + 1) * T, :].reshape(N, 8)
        dpad = dpad + jnp.pad(chunk, ((j * T, 2 * W - j * T), (0, 0)))
    want = np.array(dpad[W:W + N].astype(jnp.float32))
    got = wg.overlap_add(torch.from_numpy(dslab).bfloat16(), N, W, T)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
