"""The fused window-conv slice (K1): the JAX Pallas kernel (interpret mode
on CPU) against its own oracle, the port's plain version of the kernel
against the Pallas kernel on the same numpy inputs, the weight packing, the
conv's xyz fold, and the port's fused-conv bench end to end on the CPU.

Tolerances: float32 results agree to 1e-5 relative to the largest output
magnitude (the sums run in other orders).  In bfloat16 the Pallas kernel
forms ``sx @ wsx`` as three bf16 outer products while the oracle and the
port sum the products in float32, and every hidden state is rounded to
bf16, so the outputs differ by a few bf16 ulps of the output's scale: the
bound is 2^-6 of the largest output magnitude (2 to 4 bf16 ulps of it);
about 1 ulp was measured."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudsegmentation_tpu.data import toy as jtoy
from pointcloudsegmentation_tpu.models import fast_conv as jfc
from pointcloudsegmentation_tpu.ops import morton as jmorton
from pointcloudsegmentation_tpu.ops import search as jsearch
from pointcloudsegmentation_tpu.ops.pallas import fused_conv as jk1
from pointcloudsegmentation_tpu_torch import bench_fused_conv as bench
from pointcloudsegmentation_tpu_torch.convert import load_flax_params
from pointcloudsegmentation_tpu_torch.kernels import fused_conv as k1
from pointcloudsegmentation_tpu_torch.models import fast_conv as tfc
from pointcloudsegmentation_tpu_torch.ops.types import WindowedNeighborhood

torch.set_num_threads(1)

CASES = [  # n, tile (= window), k, dims
    (512, 64, 8, (4, 4, 8)),
    (1024, 128, 8, (8, 8, 16, 32)),
    (512, 64, 24, (16, 16, 16, 48)),    # a level-1 conv of the flagship
]
F32_REL = 1e-5
BF16_REL = 2.0 ** -6        # 2 to 4 bf16 ulps of the largest |out|


def k1_inputs(n, tile, k, dims, dtype, seed=0, out_of_slab=False,
              window=None, prefix=False):
    """Numpy inputs of one K1 call: a zero-padded [nbr_proj ‖ hi ‖ mid]
    stream, centre projections, coordinates in a 3 m block, slab-local
    indices with a fifth of the slots invalid (and, with ``out_of_slab``,
    a few indices past the slab, which read a zero row), and weights of
    unit scale (normal, divided by the square root of the fan-in).  The
    window is the tile unless ``window`` is given.  With ``prefix`` each
    point's valid slots are a prefix of its row of any length from 0 to K,
    as the search's band compaction leaves them, so whole 16-slot groups
    are empty."""
    rng = np.random.RandomState(seed)
    window = tile if window is None else window
    s = tile + 2 * window
    sumd = sum(dims)
    offs = np.cumsum((0,) + tuple(dims))
    xyz = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    if dtype == "bfloat16":
        hi = np.asarray(jnp.asarray(xyz).astype(jnp.bfloat16)
                        .astype(jnp.float32))
    else:
        hi = xyz
    mid = xyz - hi
    fp = np.concatenate([rng.randn(n, sumd).astype(np.float32), hi, mid], -1)
    fpx = np.pad(fp, ((window, window), (0, 0)))
    cen = rng.randn(n, sumd).astype(np.float32)
    xyzc = np.concatenate([xyz, np.zeros((n, 1), np.float32)], -1)
    lidx = rng.randint(0, s, (n, k)).astype(np.int32)
    lidx[rng.rand(n, k) < 0.2] = -1
    lidx[::7] = -1                          # points with no valid slot
    if prefix:
        count = rng.randint(0, k + 1, n)
        count[::7] = 0
        lidx = np.where(np.arange(k)[None, :] < count[:, None], lidx % s,
                        -1).astype(np.int32)
    if out_of_slab:
        lidx[1::5, 0] = s + 3
    wsx = (rng.randn(3, sumd) / np.sqrt(3)).astype(np.float32)
    whids = tuple((rng.randn(offs[i], dims[i]) / np.sqrt(offs[i]))
                  .astype(np.float32) for i in range(1, len(dims)))
    return fpx, cen, xyzc, lidx, wsx, whids, window, tile, tuple(dims)


def _jax(args, dtype):
    fpx, cen, xyzc, lidx, wsx, whids, window, tile, dims = args
    c = lambda a: jnp.asarray(a).astype(getattr(jnp, dtype))  # noqa: E731
    return (c(fpx), c(cen), jnp.asarray(xyzc), jnp.asarray(lidx), c(wsx),
            tuple(c(w) for w in whids), window, tile, dims)


def _torch(args, dtype):
    fpx, cen, xyzc, lidx, wsx, whids, window, tile, dims = args
    c = lambda a: torch.from_numpy(a).to(getattr(torch, dtype))  # noqa: E731
    return (c(fpx), c(cen), torch.from_numpy(xyzc), torch.from_numpy(lidx),
            c(wsx), tuple(c(w) for w in whids), window, tile, dims)


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if not isinstance(x, torch.Tensor) else x.float().numpy()


def _close(got, want, dtype):
    rel = F32_REL if dtype == "float32" else BF16_REL
    scale = np.abs(want[want > -1e29]).max()
    np.testing.assert_array_equal(got <= -1e29, want <= -1e29)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"n{c[0]}-d{len(c[3])}")
def test_pallas_kernel_matches_oracle(case, dtype):
    """The TPU kernel, run in interpret mode on the CPU, against
    ``reference_window_conv`` (indices inside the slab: the oracle clips
    where the kernel's one-hot reads zeros)."""
    args = _jax(k1_inputs(*case, dtype), dtype)
    got = _f32(jk1.fused_window_conv_fwd(*args))
    want = _f32(jk1.reference_window_conv(*args))
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"n{c[0]}-d{len(c[3])}")
def test_reference_matches_pallas_kernel(case, dtype):
    """The port's plain version of K1 against the Pallas kernel on the same
    inputs, indices past the slab included; on CPU tensors the wrapper is
    the plain version and launches nothing."""
    np_args = k1_inputs(*case, dtype, seed=1, out_of_slab=True)
    want = _f32(jk1.fused_window_conv_fwd(*_jax(np_args, dtype)))
    targs = _torch(np_args, dtype)
    got = k1.fused_window_conv_reference(*targs)
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (case[0], case[3][-1])
    _close(_f32(got), want, dtype)
    before = k1.fused_window_conv_fwd.launches
    assert torch.equal(k1.fused_window_conv_fwd(*targs), got)
    assert k1.fused_window_conv_fwd.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_matches_pallas_kernel_any_window(dtype):
    """A window that is no multiple of the tile (the TPU kernel slices its
    slab at any offset): the port takes it and agrees with the Pallas
    kernel."""
    np_args = k1_inputs(512, 64, 8, (4, 4, 8), dtype, seed=2,
                        out_of_slab=True, window=96)
    want = _f32(jk1.fused_window_conv_fwd(*_jax(np_args, dtype)))
    got = k1.fused_window_conv_fwd(*_torch(np_args, dtype))
    _close(_f32(got), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_matches_pallas_kernel_prefix_slots(dtype):
    """Valid slots a prefix of each row, whole 16-slot groups empty (the
    groups the card's bf16 kernel skips): the port's plain version agrees
    with the Pallas kernel, and a point with no valid slot gives -1e30."""
    np_args = k1_inputs(512, 64, 32, (8, 8, 16, 32), dtype, seed=3,
                        prefix=True)
    lidx = np_args[3]
    valid = lidx >= 0
    assert (np.diff(valid.astype(int), axis=1) <= 0).all()
    assert (~valid[:, 16:].any(1)).mean() > 0.3
    want = _f32(jk1.fused_window_conv_fwd(*_jax(np_args, dtype)))
    got = _f32(k1.fused_window_conv_fwd(*_torch(np_args, dtype)))
    _close(got, want, dtype)
    assert (got[~valid.any(1)] <= -1e29).all()


@pytest.mark.parametrize("bad,match", [
    ("hidden", "tiles of 8 columns"),
    ("output", "tiles of 8 columns"),
    ("fpx", "fpx 4-byte aligned"),
    ("cen", "cen 4-byte aligned"),
])
def test_kernel_check_refuses_what_the_bf16_kernel_cannot_take(bad, match):
    """The checks the CUDA path adds for the bf16 kernel: at most 16 tiles
    of 8 columns of hidden state and of output, fpx and cen 4-byte aligned;
    float32 and in-range bf16 inputs pass."""
    fpx = torch.zeros(64, 2, dtype=torch.bfloat16)
    cen = torch.zeros(64, 2, dtype=torch.bfloat16)
    dims = {"hidden": (64, 72, 8), "output": (8, 136)}.get(bad, (8, 8))
    if bad == "fpx":
        fpx = fpx.reshape(-1)[1:]
    if bad == "cen":
        cen = cen.reshape(-1)[1:]
    with pytest.raises(ValueError, match=match):
        k1._check_kernel(fpx, cen, dims)
    k1._check_kernel(fpx.float(), cen.float(), dims)
    k1._check_kernel(torch.zeros(4, dtype=torch.bfloat16),
                     torch.zeros(4, dtype=torch.bfloat16), (64, 64, 128))


def test_fused_conv_refuses_grad_and_bad_input():
    args = list(_torch(k1_inputs(*CASES[0], "float32"), "float32"))
    for i in (0, 1, 2, 4):
        bad = list(args)
        bad[i] = args[i].clone().requires_grad_()
        with pytest.raises(RuntimeError, match="no backward"):
            k1.fused_window_conv_fwd(*bad)
    bad = list(args)
    bad[5] = (args[5][0].clone().requires_grad_(),) + args[5][1:]
    with pytest.raises(RuntimeError, match="no backward"):
        k1.fused_window_conv_fwd(*bad)
    with pytest.raises(TypeError):              # int64 indices
        k1.fused_window_conv_fwd(*args[:3], args[3].long(), *args[4:])
    with pytest.raises(ValueError):             # fpx without its pad rows
        k1.fused_window_conv_fwd(args[0][:-1], *args[1:])
    with pytest.raises(ValueError):             # a missing hidden kernel
        k1.fused_window_conv_fwd(*args[:5], args[5][:-1], *args[6:])
    with pytest.raises(TypeError):              # mixed compute dtypes
        k1.fused_window_conv_fwd(args[0], args[1].bfloat16(), *args[2:])


def _windowed(n, radius, k, seed=7):
    rng = np.random.RandomState(seed)
    xyz = jtoy.synthetic_room_block(rng, n=n)["xyz"]
    mask = np.ones(n, bool)
    mask[-30:] = False
    xyz, mask, _ = jmorton.sort_block(xyz, mask, 0.0375, 3.0)
    xyz, mask = np.array(xyz), np.array(mask)
    (jwn, sxyz), = jsearch.windowed_multi_band_neighbors(
        xyz, mask, ((0.0, radius, k),), tile=256, window=256, cand_k=32,
        ov_slots=8, chunk=1024, return_sxyz=True, ov_pool_size=256,
        sel_mode="slab")
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    twn = WindowedNeighborhood(lidx=t(jwn.lidx), wmask=t(jwn.wmask),
                               ov_idx=t(jwn.ov_idx), ov_mask=t(jwn.ov_mask),
                               window=256, tile=256, pool_idx=t(jwn.pool_idx))
    return xyz, mask, jwn, twn, np.array(sxyz)


@pytest.mark.parametrize("fc_dims,out", [((8, 8, 16), 32), ((16, 16, 32), 64)])
def test_pointnet_conv_fast_xyz_fold(fc_dims, out):
    """The layer's xyz fold (neighbor coordinates gathered beside the
    projections) against the JAX layer's, float32, converted weights, with
    windowed and overflow slots."""
    n, radius = 1024, 0.45
    xyz, mask, jwn, twn, sxyz = _windowed(n, radius, 24)
    assert np.array(jwn.ov_mask).any()
    feats = np.random.RandomState(3).randn(n, 20).astype(np.float32)
    jmod = jfc.PointNetConvFast(fc_dims, out)
    params = jax.tree_util.tree_map(
        np.array, jmod.init(jax.random.PRNGKey(0), sxyz / radius, feats, jwn))
    want = np.array(jmod.apply(params, None, feats, jwn, xyz=xyz,
                               inv_rescale=1.0 / radius))
    tmod = load_flax_params(tfc.PointNetConvFast(20, fc_dims, out), params)
    with torch.no_grad():
        got = tmod(None, torch.from_numpy(feats), twn,
                   xyz=torch.from_numpy(xyz), inv_rescale=1.0 / radius)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert np.all(got.numpy()[~mask] == 0.0)
    # the fold and the search's sxyz give the same conv up to rounding
    with torch.no_grad():
        via_sxyz = tmod(torch.from_numpy(sxyz / radius),
                        torch.from_numpy(feats), twn)
    np.testing.assert_allclose(got.numpy(), via_sxyz.numpy(), atol=1e-4,
                               rtol=1e-4)


def _jax_pack(p, dims, radius):
    """The packing of ``scripts/bench_fused_conv.py`` (lines 89-111)."""
    wnbr = jnp.concatenate([p[f"fc_{i}_nbr"]["kernel"]
                            for i in range(len(dims))], axis=-1)
    wcen = jnp.concatenate([p[f"fc_{i}_cen"]["kernel"]
                            for i in range(len(dims))], axis=-1)
    bcen = jnp.concatenate([p[f"fc_{i}_cen"]["bias"]
                            for i in range(len(dims))], axis=-1)
    wsx = jnp.concatenate([p[f"fc_{i}_sxyz"]["kernel"]
                           for i in range(len(dims))], axis=-1) / radius
    whids = []
    for i in range(1, len(dims)):
        whids.append(jnp.concatenate(
            [p[f"fc_{i}_h{j}"]["kernel"] for j in range(i)], axis=0))
    cdt = jnp.bfloat16
    return (wnbr.astype(cdt), wcen.astype(cdt), bcen.astype(cdt),
            wsx.astype(cdt), tuple(w.astype(cdt) for w in whids))


@pytest.mark.parametrize("level", [0, 1])
def test_pack_fused_conv_matches_jax_script(level):
    spec = bench.LEVELS[level]
    dims, f, radius = spec["dims"], spec["f"], spec["radius"]
    n = 512
    rng = np.random.RandomState(level)
    feats = rng.randn(n, f).astype(np.float32)
    sxyz = rng.randn(n, 4, 3).astype(np.float32)
    from pointcloudsegmentation_tpu.ops.types import Neighborhood
    nbr = Neighborhood(idx=jnp.zeros((n, 4), jnp.int32),
                       mask=jnp.ones((n, 4), bool))
    jmod = jfc.PointNetConvFast(dims[:-1], dims[-1])
    params = jax.tree_util.tree_map(
        np.array, jmod.init(jax.random.PRNGKey(level), sxyz, feats, nbr))
    want = _jax_pack(params["params"], dims, radius)
    tmod = load_flax_params(tfc.PointNetConvFast(
        f, dims[:-1], dims[-1], dtype=torch.bfloat16), params)
    got = k1.pack_fused_conv(tmod, radius)
    assert got.dims == dims
    for g, w in zip(got[:4] + got.whids, want[:4] + want[4]):
        assert g.dtype == torch.bfloat16 and g.is_contiguous()
        np.testing.assert_array_equal(_f32(g), _f32(w))


def test_split_xyz_rebuilds_coordinates():
    xyz = torch.from_numpy(np.random.RandomState(0).uniform(
        -1.5, 1.5, (256, 3)).astype(np.float32))
    hi, mid = tfc.split_xyz(xyz, torch.bfloat16)
    assert hi.dtype == mid.dtype == torch.bfloat16
    err = (hi.float() + mid.float() - xyz).abs() / xyz.abs().clamp(min=1e-3)
    assert float(err.max()) <= 2.0 ** -16


@pytest.mark.parametrize("level", [0, 1])
def test_bench_cross_check_on_cpu(level):
    """The fused-conv bench's cross-check end to end on the CPU at 1024
    points: K1's plain version against the conv's xyz fold on the windowed
    slots.  float32 agrees to rounding; bf16 within 2^-6 of the largest
    output (the unfused conv rounds after every projection and add)."""
    err, scale = bench.cross_check(
        bench.setup(level, "cpu", n=1024, dtype=torch.float32))
    assert scale > 1 and err <= F32_REL * scale
    err, scale = bench.cross_check(bench.setup(level, "cpu", n=1024))
    assert scale > 1 and 0 < err <= BF16_REL * scale
