"""The port's scene parallelism (``parallel/scene_shard.py``) on 4 gloo CPU
ranks against the JAX package's on a 4-device submesh of the CPU mesh,
with the same numpy inputs: the ring halo exchange and its validity mask
exactly, the geometric halo's selected rows exactly (coordinates on a
1/1024 m lattice, where the squared distances are exact; with and
without lattice cells), the data-driven halo rules as the same integers,
``scene_apply`` in both halo modes with ``tiny_s3dis``'s converted
weights, the refusal of a halo below the requirement with the same
number; and the port's sequential emulation (``extended_shard``,
``sequential_scene_apply``) against its own sharded run.  The 4 ranks are
spawned once for the module (``torch_ranks.scene_body``)."""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_ranks as R
from jax import shard_map
from jax.sharding import PartitionSpec as P
from test_torch_model import random_params

from pointcloudsegmentation_tpu.ops import morton as jmorton
from pointcloudsegmentation_tpu.parallel import make_mesh
from pointcloudsegmentation_tpu.parallel import scene_shard as jss
from pointcloudsegmentation_tpu.train import build_model as jbuild
from pointcloudsegmentation_tpu.train import s3dis_config as js3dis
from pointcloudsegmentation_tpu_torch.convert import flax_to_state_dict
from pointcloudsegmentation_tpu_torch.parallel import scene_shard as tss

torch.set_num_threads(1)

EXT = R.L + 2 * R.HALO


@pytest.fixture(scope="module")
def jax_model():
    """``tiny_s3dis`` for the extended shard with seeded random weights."""
    cfg = js3dis(model="tiny_s3dis", data_num_points=EXT,
                 data_caps=(192, 48), compute_dtype="float32")
    model = jbuild(cfg, search_chunk=128)
    params = random_params(model, np.zeros((EXT, 3), np.float32),
                           np.zeros((EXT, 12), np.float32),
                           np.ones(EXT, bool), seed=2)
    return model, params


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_model):
    tmp = tmp_path_factory.mktemp("scene_ranks")
    torch.save(flax_to_state_dict(jax_model[1]), tmp / "scene_sd.pt")
    return R.spawn_once(R.scene_body, R.SHARDS, tmp)


def _per_device(fn, *arrays):
    """``fn`` on each device's shard of ``arrays`` under ``shard_map`` on
    the 4-device mesh; every output stacked per device, as numpy."""
    return _device_program(fn)(*arrays)


@functools.lru_cache(maxsize=None)
def _device_program(fn):
    """One jitted ``shard_map`` program of ``fn`` (cached: a program takes
    seconds to compile on the CPU)."""
    mesh = make_mesh(R.SHARDS)

    @jax.jit
    def run(*xs):
        return shard_map(
            lambda *shards: jax.tree_util.tree_map(lambda t: t[None],
                                                   fn(*shards)),
            mesh=mesh, in_specs=(P("data"),) * len(xs),
            out_specs=P("data"))(*xs)

    return lambda *arrays: jax.tree_util.tree_map(
        np.asarray, run(*(jnp.asarray(a) for a in arrays)))


def test_halo_exchange_ring_matches_jax(ranks):
    x = np.arange(R.SHARDS * 16, dtype=np.float32)[:, None]
    want = _per_device(lambda xs: jss.halo_exchange(xs, 4, "data"), x)
    for r in range(R.SHARDS):
        np.testing.assert_array_equal(ranks[r]["ring"].numpy(), want[r])


def test_halo_validity_matches_jax(ranks):
    m = np.ones(R.SHARDS * 16, bool)
    want = _per_device(lambda ms: jss.halo_validity(
        jss.halo_exchange(ms, 4, "data"), 4, "data"), m)
    for r in range(R.SHARDS):
        np.testing.assert_array_equal(ranks[r]["validity"].numpy(), want[r])


def _inputs(name):
    x, f, m = R.line_scene() if name == "line" else R.sorted_scene(1)
    return x.numpy(), f.numpy(), m.numpy()


@functools.lru_cache(maxsize=None)
def _geometric_exchanges(cell):
    """JAX's geometric exchange at both halos in one program."""
    return lambda xs, fs, ms: {halo: jss.geometric_halo_exchange(
        xs, fs, ms, halo, "data", cell_size=cell) for halo in (4, R.HALO)}


@pytest.mark.parametrize("name", ["line", "scene"])
@pytest.mark.parametrize("cell", [0.0, R.CELL])
@pytest.mark.parametrize("halo", [4, R.HALO])
def test_geometric_halo_rows_match_jax(ranks, name, cell, halo):
    """Each rank receives the rows JAX's device receives (the feature
    column is the sorted row index), with the same coordinates and mask."""
    want = _per_device(_geometric_exchanges(cell), *_inputs(name))[halo]
    for r in range(R.SHARDS):
        got = ranks[r][f"geom_{name}_{cell}_{halo}"]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w[r])


def _index_exchange(xs, fs, ms):
    me = jss.halo_exchange(ms, R.HALO, "data")
    return (jss.halo_exchange(xs, R.HALO, "data"),
            jss.halo_exchange(fs, R.HALO, "data"),
            jss.halo_validity(me, R.HALO, "data"))


@pytest.mark.parametrize("name", ["line", "scene"])
def test_index_halo_matches_jax(ranks, name):
    want = _per_device(_index_exchange, *_inputs(name))
    for r in range(R.SHARDS):
        for g, w in zip(ranks[r][f"index_{name}"], want):
            np.testing.assert_array_equal(g.numpy(), w[r])


def _jax_sorted(seed):
    xyz, _, mask = R.lattice_scene(seed)
    xs, ms, _ = jmorton.sort_block(jnp.asarray(xyz), jnp.asarray(mask),
                                   R.SORT_CELL, R.EXTENT)
    return np.asarray(xs), np.asarray(ms)


@pytest.mark.parametrize("shards", [4, 8])
@pytest.mark.parametrize("rule", ["index_0.2_100", "index_1.0_100",
                                  "index_1.0_99", "geom_0.6_0",
                                  "geom_0.6_0.45", "geom_1.0_0.45"])
def test_halo_rules_match_jax(rule, shards):
    """``required_halo`` and ``geometric_required_halo`` give the JAX
    integers (and the same unreachable count) on the sorted scene."""
    kind, rf, arg = rule.split("_")
    xs, ms = _jax_sorted(3)
    tsorted = R.sorted_scene(3)
    np.testing.assert_array_equal(tsorted[0].numpy(), xs)
    if kind == "index":
        want = jss.required_halo(xs, ms, shards, float(rf), float(arg))
        got = tss.required_halo(xs, ms, shards, float(rf), float(arg))
    else:
        want = jss.geometric_required_halo(xs, ms, shards, float(rf),
                                           cell_size=float(arg))
        got = tss.geometric_required_halo(xs, ms, shards, float(rf),
                                          cell_size=float(arg))
        assert got[0] > 1
    assert got == want


def _jax_scene_apply(jax_model, mode, cell):
    model, params = jax_model
    xyz, feats, mask = R.lattice_scene(0)
    return np.asarray(jss.scene_apply(
        lambda p, x, f, m: model.apply(p, x, f, m, False), params,
        jnp.asarray(xyz), jnp.asarray(feats), jnp.asarray(mask),
        make_mesh(R.SHARDS), halo=R.HALO, halo_mode=mode, halo_cell=cell,
        **R.SORT))


@pytest.mark.parametrize("mode,cell", [("index", 0.0), ("geom", R.CELL)])
def test_scene_apply_matches_jax(ranks, jax_model, mode, cell):
    """Every rank returns the whole scene's logits in the input order,
    within 1e-4 of the largest |JAX logit| (at least 1)."""
    want = _jax_scene_apply(jax_model, mode, cell)
    mask = R.lattice_scene(0)[2]
    scale = max(1.0, np.abs(want[mask]).max())
    for r in range(R.SHARDS):
        got = ranks[r][f"apply_{mode}"].numpy()
        assert got.shape == want.shape == (R.SCENE_N, 13)
        np.testing.assert_allclose(got[mask] / scale, want[mask] / scale,
                                   rtol=0, atol=1e-4)


@pytest.mark.parametrize("mode,rf,cell", [("index", 0.6, 0.0),
                                          ("geom", 1.0, 0.45)])
def test_halo_below_requirement_raises_like_jax(ranks, mode, rf, cell):
    xyz, feats, mask = R.lattice_scene(0)

    def boom(*a):
        raise AssertionError("apply_fn must not run")

    with pytest.raises(ValueError, match="data-driven requirement") as e:
        jss.scene_apply(boom, None, jnp.asarray(xyz), jnp.asarray(feats),
                        jnp.asarray(mask), make_mesh(R.SHARDS), halo=1,
                        receptive_field=rf, halo_percentile=100.0,
                        halo_mode=mode, halo_cell=cell, **R.SORT)
    need = re.search(r"requirement (\d+)", str(e.value)).group(1)
    assert int(need) > 1
    for r in range(R.SHARDS):
        msg = ranks[r][f"raise_{mode}"]
        assert re.search(r"requirement (\d+)", msg).group(1) == need, msg


@pytest.mark.parametrize("mode,cell", [("index", 0.0), ("geom", R.CELL)])
def test_sequential_emulation_equals_scene_apply(ranks, jax_model, mode,
                                                 cell):
    """``sequential_scene_apply`` in one process gives each rank's logits
    bit for bit, and ``extended_shard`` each rank's received rows."""
    model = R.scene_model(EXT)
    model.load_state_dict(flax_to_state_dict(jax_model[1]))
    model.eval()
    xyz, feats, mask = (torch.from_numpy(a) for a in R.lattice_scene(0))
    with torch.no_grad():
        want = tss.sequential_scene_apply(
            lambda x, f, m: model(x, f, m, train=False), xyz, feats, mask,
            R.SHARDS, R.HALO, halo_mode=mode, halo_cell=cell, **R.SORT)
    xs, fs, ms = R.sorted_scene(1)
    for r in range(R.SHARDS):
        assert torch.equal(ranks[r][f"apply_{mode}"], want)
        x, f, m, rows = tss.extended_shard(xs, fs, ms, R.SHARDS, r, R.HALO,
                                           mode, cell)
        got = ranks[r][f"geom_scene_{cell}_{R.HALO}"] if mode == "geom" \
            else ranks[r]["index_scene"]
        assert torch.equal(got[1][:, 0].long(), rows)
        for g, w in zip(got, (x, f, m)):
            assert torch.equal(g, w)
