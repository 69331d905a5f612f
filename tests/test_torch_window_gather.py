"""The window-gather kernel's plain version against the JAX Pallas kernel
(interpret mode on CPU), bit for bit, and the port's windowed/pooled
neighbor gathers against the JAX package's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudsegmentation_tpu.data import toy
from pointcloudsegmentation_tpu.ops import morton as jmorton
from pointcloudsegmentation_tpu.ops import neighbors as jnb
from pointcloudsegmentation_tpu.ops import search as jsearch
from pointcloudsegmentation_tpu.ops.pallas import gather_fwd as pallas_gather
from pointcloudsegmentation_tpu.ops.types import \
    WindowedNeighborhood as JWindowed
from pointcloudsegmentation_tpu_torch.kernels import window_gather as wg
from pointcloudsegmentation_tpu_torch.ops import neighbors as tnb
from pointcloudsegmentation_tpu_torch.ops.types import \
    WindowedNeighborhood as TWindowed

torch.set_num_threads(1)

N, T, W = 512, 128, 128
S = T + 2 * W


@pytest.mark.parametrize("f,k,dtype", [(64, 8, "bfloat16"),
                                       (96, 4, "bfloat16"),
                                       (4, 32, "float32"),
                                       # the flagship's level-1 and -2 widths
                                       (96, 24, "bfloat16"),
                                       (96, 32, "bfloat16"),
                                       (128, 24, "bfloat16"),
                                       (128, 32, "bfloat16")])
def test_reference_matches_pallas_gather(f, k, dtype):
    rng = np.random.RandomState(f + k)
    feats = rng.randn(N, f).astype(np.float32)
    lidx = rng.randint(0, S, (N, k)).astype(np.int32)
    lidx[:, 0] = 0          # zero-padded rows before the block's start
    lidx[:, 1] = S - 1      # ... and past its end
    jf = jnp.asarray(feats).astype(getattr(jnp, dtype))
    want = np.array(pallas_gather(jf, jnp.asarray(lidx), W, T)
                    .astype(jnp.float32))
    tf = torch.from_numpy(feats).to(getattr(torch, dtype))
    tl = torch.from_numpy(lidx)
    got = wg.gather_fwd_reference(tf, tl, W, T)
    assert got.dtype == tf.dtype and got.shape == (N, k, f)
    np.testing.assert_array_equal(got.float().numpy(), want)
    # on a CPU tensor the wrapper runs the plain version and launches nothing
    before = wg.gather_fwd.launches
    assert torch.equal(wg.gather_fwd(tf, tl, W, T), got)
    assert wg.gather_fwd.launches == before


@pytest.mark.parametrize("f,k,dtype", [(64, 8, "bfloat16"),
                                       (4, 16, "float32")])
def test_reference_matches_pallas_gather_wide_window(f, k, dtype):
    """The wide overflow tier's geometry: window 512 over tiles of 256 (a
    slab of 1280 rows), its 8 slots of bf16 features and the search's
    16-candidate float32 xyzm read."""
    n, t, w = 1024, 256, 512
    s = t + 2 * w
    rng = np.random.RandomState(f * k)
    feats = rng.randn(n, f).astype(np.float32)
    lidx = rng.randint(0, s, (n, k)).astype(np.int32)
    lidx[:, 0] = 0          # rows before the block's start
    lidx[:, 1] = s - 1      # ... and past its end
    jf = jnp.asarray(feats).astype(getattr(jnp, dtype))
    want = np.array(pallas_gather(jf, jnp.asarray(lidx), w, t)
                    .astype(jnp.float32))
    got = wg.gather_fwd_reference(
        torch.from_numpy(feats).to(getattr(torch, dtype)),
        torch.from_numpy(lidx), w, t)
    assert got.shape == (n, k, f)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_gather_fwd_rejects_bad_input():
    f = torch.zeros(N, 8)
    li = torch.zeros(N, 4, dtype=torch.int32)
    with pytest.raises(ValueError):
        wg.gather_fwd(f[:N - 1], li[:N - 1], W, T)     # N % T != 0
    with pytest.raises(ValueError):
        wg.gather_fwd(f, li, W + 1, T)                 # W % T != 0
    with pytest.raises(TypeError):
        wg.gather_fwd(f, li.long(), W, T)
    # the raw entry point records no backward and refuses a tensor that
    # requires grad; the differentiable gather carries the gradient
    fg = f.clone().requires_grad_()
    with pytest.raises(RuntimeError):
        wg.gather_fwd(fg, li, W, T)
    own = (torch.arange(N, dtype=torch.int32) % T + W)[:, None]
    wn = TWindowed(lidx=own.repeat(1, 4), wmask=torch.ones(N, 4, dtype=bool),
                   ov_idx=torch.zeros(N, 0, dtype=torch.int32),
                   ov_mask=torch.zeros(N, 0, dtype=bool), window=W, tile=T)
    out = tnb.windowed_gather(fg, wn)
    assert out.requires_grad
    out.sum().backward()
    assert torch.equal(fg.grad, torch.full_like(f, 4.0))   # 4 slots each


@pytest.fixture(scope="module")
def windowed_nbr():
    """A pooled WindowedNeighborhood from the JAX search at N=1024."""
    rng = np.random.RandomState(5)
    xyz = toy.synthetic_room_block(rng, n=1024)["xyz"]
    mask = np.ones(1024, bool)
    xyz, mask, _ = jmorton.sort_block(xyz, mask, 0.0375, 3.0)
    bands = ((0.0, 0.45, 32), (0.3, 0.45, 16))
    res = jsearch.windowed_multi_band_neighbors(
        xyz, mask, bands, tile=256, window=256, cand_k=32, ov_slots=8,
        chunk=1024, ov_pool_size=256, sel_mode="slab")
    return res[0]


def _to_torch(wn: JWindowed) -> TWindowed:
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return TWindowed(lidx=t(wn.lidx), wmask=t(wn.wmask), ov_idx=t(wn.ov_idx),
                     ov_mask=t(wn.ov_mask), window=wn.window, tile=wn.tile,
                     pool_idx=t(wn.pool_idx))


def test_windowed_and_pooled_gather(windowed_nbr):
    jwn = windowed_nbr
    twn = _to_torch(jwn)
    assert np.array(jwn.ov_mask).any()
    feats = np.random.RandomState(1).randn(1024, 24).astype(np.float32)
    tf = torch.from_numpy(feats)
    np.testing.assert_array_equal(tnb.windowed_gather(tf, twn).numpy(),
                                  np.array(jnb.windowed_gather(feats, jwn)))
    np.testing.assert_array_equal(tnb.gather_neighbors(tf, twn).numpy(),
                                  np.array(jnb.gather_neighbors(feats, jwn)))
    # the global view agrees too
    np.testing.assert_array_equal(twn.global_idx.numpy(),
                                  np.array(jwn.global_idx))
    nb = twn.to_neighborhood()
    np.testing.assert_array_equal(tnb.gather_neighbors(tf, nb).numpy(),
                                  tnb.gather_neighbors(tf, twn).numpy())
