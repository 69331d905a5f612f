"""The port's data pipeline against the JAX package's: under the same
``RandomState`` seeds its own copies of ``io_util``, ``augment``, ``s3dis``,
``synth_rooms``, ``scannet``, ``semantic3d``, ``batching`` and
``Provider`` give arrays
equal to the JAX package's, and its native bindings give the JAX native
library's results."""
import functools

import numpy as np
import pytest

from pointcloudsegmentation_tpu.data import augment as jaugment
from pointcloudsegmentation_tpu.data import batching as jbatching
from pointcloudsegmentation_tpu.data import io_util as jio
from pointcloudsegmentation_tpu.data import native as jnative
from pointcloudsegmentation_tpu.data import provider as jprovider
from pointcloudsegmentation_tpu.data import s3dis as js3dis
from pointcloudsegmentation_tpu.data import scannet as jscannet
from pointcloudsegmentation_tpu.data import semantic3d as jsemantic3d
from pointcloudsegmentation_tpu.data import synth_rooms as jsynth
from pointcloudsegmentation_tpu_torch.data import augment as taugment
from pointcloudsegmentation_tpu_torch.data import batching as tbatching
from pointcloudsegmentation_tpu_torch.data import io_util as tio
from pointcloudsegmentation_tpu_torch.data import native as tnative
from pointcloudsegmentation_tpu_torch.data import provider as tprovider
from pointcloudsegmentation_tpu_torch.data import s3dis as ts3dis
from pointcloudsegmentation_tpu_torch.data import scannet as tscannet
from pointcloudsegmentation_tpu_torch.data import semantic3d as tsemantic3d
from pointcloudsegmentation_tpu_torch.data import synth_rooms as tsynth


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    """The JAX package takes its native paths only where its library is
    built; build it so both packages take the same branches."""
    jnative.ensure_built()
    assert jnative.available()


def assert_same(got, want, path="out"):
    """Equal structure, dtypes and values (lists, tuples, dicts, arrays)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, path


@functools.lru_cache(maxsize=None)
def _room(seed=0, hard=False):
    return jsynth.synthetic_s3dis_room(np.random.RandomState(seed),
                                       hard=hard)


def _both(fn_j, fn_t, *args, seed=0, **kw):
    """Call the JAX and the port function with the same args, each with a
    fresh ``RandomState(seed)`` as ``rng`` when ``seed`` is not None."""
    if seed is None:
        return fn_j(*args, **kw), fn_t(*args, **kw)
    return (fn_j(*args, rng=np.random.RandomState(seed), **kw),
            fn_t(*args, rng=np.random.RandomState(seed), **kw))


# -- native bindings ---------------------------------------------------------

def test_native_bindings_match_the_jax_library():
    rng = np.random.RandomState(1)
    xyz = rng.uniform(0, 3, (3000, 3)).astype(np.float32)
    query = rng.uniform(0, 3, (500, 3)).astype(np.float32)
    assert_same(tnative.grid_downsample(xyz, 0.1),
                jnative.grid_downsample(xyz, 0.1))
    assert_same(tnative.radius_neighbors(xyz, query, 0.2, 16),
                jnative.radius_neighbors(xyz, query, 0.2, 16))
    assert_same(tnative.knn(xyz, query, 6, 0.3),
                jnative.knn(xyz, query, 6, 0.3))
    qidx = rng.choice(3000, 400, replace=False).astype(np.int32)
    assert_same(tnative.compute_covars(xyz, qidx, 0.15),
                jnative.compute_covars(xyz, qidx, 0.15))


# -- io_util -----------------------------------------------------------------

def test_io_util_copy(tmp_path):
    points, labels = _room(0)
    tio.save_room_pkl(str(tmp_path / "t.pkl"), points, labels)
    jio.save_room_pkl(str(tmp_path / "j.pkl"), points, labels)
    for path in ("t.pkl", "j.pkl"):
        assert_same(tio.read_room_pkl(str(tmp_path / path)),
                    jio.read_room_pkl(str(tmp_path / path)))
    jio.save_pkl(str(tmp_path / "d.pkl"), {"points": points[:50],
                                           "labels": labels[:50]})
    assert_same(tio.read_room_pkl(str(tmp_path / "d.pkl")),
                jio.read_room_pkl(str(tmp_path / "d.pkl")))
    stems = ["Area_1_office_1", "Area_5_hallway_2", "Area_2_wc_1",
             "Area_5_office_7"]
    (tmp_path / "stems.txt").write_text("\n".join(stems) + "\n\n")
    assert_same(tio.read_stems(str(tmp_path / "stems.txt")),
                jio.read_stems(str(tmp_path / "stems.txt")))
    assert_same(tio.get_train_test_split(stems, 5),
                jio.get_train_test_split(stems, 5))
    depth = np.random.RandomState(2).uniform(0, 4, (24, 32))
    depth[3:6, 4:9] = 0
    assert_same(tio.depth_to_points(depth, 50.0, 52.0),
                jio.depth_to_points(depth, 50.0, 52.0))


# -- augment -----------------------------------------------------------------

def test_augment_transforms_and_searches():
    rng = np.random.RandomState(3)
    pts = rng.randn(400, 6).astype(np.float32)
    xyz = np.ascontiguousarray(pts[:, :3] * 0.5)
    for name, args in (("flip", (pts, 1)), ("swap_xy", (pts,)),
                       ("rotate_z", (xyz, 0.7)),
                       ("grid_downsample", (xyz, 0.2))):
        assert_same(getattr(taugment, name)(*args),
                    getattr(jaugment, name)(*args), name)
    want = jaugment.radius_neighbors_host(xyz, 0.3, np.arange(0, 400, 7))
    got = taugment.radius_neighbors_host(xyz, 0.3, np.arange(0, 400, 7))
    assert [sorted(g) for g in got] == [sorted(w) for w in want]
    # native with query_idx, scipy without, as in the JAX package
    qidx = np.arange(0, 400, 3).astype(np.int32)
    assert_same(taugment.compute_covars(xyz, 0.3, qidx),
                jaugment.compute_covars(xyz, 0.3, qidx))
    assert_same(taugment.compute_covars(xyz[:120], 0.4),
                jaugment.compute_covars(xyz[:120], 0.4))
    rel = xyz - xyz.min(0, keepdims=True)
    assert_same(taugment.uniform_sample_block(rel, 1.0, 0.5, min_pn=10),
                jaugment.uniform_sample_block(rel, 1.0, 0.5, min_pn=10))
    for seed in (0, 1, 2):
        r = np.random.RandomState(seed)
        rgb = r.rand(300, 3).astype(np.float32)
        got = taugment.train_time_augment(xyz[:300], rgb,
                                          np.random.RandomState(seed))
        want = jaugment.train_time_augment(xyz[:300], rgb,
                                           np.random.RandomState(seed))
        assert_same(got, want)


@pytest.mark.parametrize("augment_geometry", [False, True])
def test_augment_sample_and_normalize_block(augment_geometry):
    points, labels = _room(1)
    kw = dict(use_rescale=augment_geometry, use_flip=augment_geometry,
              use_rotate=augment_geometry)
    for seed in (0, 4) if augment_geometry else (0,):
        got, want = _both(jaugment.sample_block, taugment.sample_block,
                          points, labels, 0.05, 3.0, 1.5, 512, seed=seed,
                          **kw)
        assert len(want[0]) >= 2
        assert_same(got, want)
    xyzs, rgbs, _, lbls = want
    assert_same(taugment.normalize_block(xyzs, rgbs, lbls),
                jaugment.normalize_block(xyzs, rgbs, lbls))
    assert_same(
        taugment.normalize_block(xyzs, rgbs, lbls, jitter_color=np.random
                                 .RandomState(5)),
        jaugment.normalize_block(xyzs, rgbs, lbls, jitter_color=np.random
                                 .RandomState(5)))


# -- s3dis, synth_rooms, scannet ---------------------------------------------

@pytest.fixture(scope="module")
def room_pkl(tmp_path_factory):
    """One synthetic room prepared by each package into a pkl."""
    points, labels = _room(2)
    d = tmp_path_factory.mktemp("rooms")
    want = js3dis.prepare_room(points, labels,
                               rng=np.random.RandomState(0))
    got = ts3dis.prepare_room(points, labels, rng=np.random.RandomState(0))
    assert_same(got, want)
    paths = []
    for name, prep in (("j", want), ("t", got)):
        path = str(d / f"room_{name}.pkl")
        js3dis.save_pkl(path, prep)
        paths.append(path)
    return paths


@pytest.mark.parametrize("model", ["train", "test"])
@pytest.mark.parametrize("use_covars", [False, True])
def test_s3dis_blocks_from_room_pkl(room_pkl, model, use_covars):
    for path in room_pkl:
        got, want = _both(js3dis.blocks_from_room_pkl,
                          ts3dis.blocks_from_room_pkl, model, path, seed=7,
                          use_covars=use_covars)
        assert len(want) > 4
        assert want[0]["feats"].shape[1] == (12 if use_covars else 3)
        assert_same(got, want)


def test_s3dis_train_test_split(tmp_path):
    path = tmp_path / "stems.txt"
    path.write_text("Area_1_a\nArea_5_b\n\nArea_6_c\n")
    assert_same(ts3dis.train_test_split(str(path), 5),
                js3dis.train_test_split(str(path), 5))


@pytest.mark.parametrize("hard", [False, True])
def test_synth_rooms_room_blocks(hard):
    got, want = _both(lambda rng, **kw: jsynth.room_blocks(rng, **kw),
                      lambda rng, **kw: tsynth.room_blocks(rng, **kw),
                      seed=11, num_rooms=1, hard=hard, with_mins=True)
    assert len(want) > 4 and "block_min" in want[0]
    assert_same(got, want)


def test_synth_rooms_two_room_scene_and_test_blocks():
    got, want = _both(lambda rng, **kw: jsynth.room_blocks(rng, **kw),
                      lambda rng, **kw: tsynth.room_blocks(rng, **kw),
                      seed=12, num_rooms=1, hard=True, rooms_per_scene=2,
                      model="test", use_covars=False)
    assert_same(got, want)


@pytest.mark.parametrize("model", ["train", "test"])
def test_scannet_prepare_and_blocks_from_scene_pkl(tmp_path, model):
    points, labels = _room(3)
    xyz = np.ascontiguousarray(points[:, :3])
    got, want = _both(jscannet.prepare_scene, tscannet.prepare_scene, xyz,
                      labels + 1, seed=0)
    assert_same(got, want)
    path = str(tmp_path / "scene.pkl")
    js3dis.save_pkl(path, want)
    got, want = _both(jscannet.blocks_from_scene_pkl,
                      tscannet.blocks_from_scene_pkl, model, path, seed=8)
    assert want[0]["feats"].shape[1] == 1
    assert_same(got, want)
    counts = np.bincount(labels, minlength=20).astype(np.float64)
    assert_same(tscannet.class_weights_from_counts(counts),
                jscannet.class_weights_from_counts(counts))


# -- semantic3d ---------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _scan(seed=0):
    """A small Semantic3D-like scan: x y z intensity r g b over 25 x 20 m,
    labels 0..8 (0 = unlabeled)."""
    rng = np.random.RandomState(seed)
    n = 12000
    pts = np.concatenate([
        rng.uniform(0, 25, (n, 1)), rng.uniform(0, 20, (n, 1)),
        rng.uniform(0, 4, (n, 1)), rng.uniform(-2000, 2000, (n, 1)),
        rng.randint(0, 256, (n, 3))], 1).astype(np.float32)
    return pts, rng.randint(0, 9, n).astype(np.int32)


def test_semantic3d_read_points_txt(tmp_path):
    pts, labels = _scan()
    np.savetxt(tmp_path / "s.txt", pts[:200], fmt="%.3f")
    np.savetxt(tmp_path / "s.labels", labels[:200], fmt="%d")
    for lab in (str(tmp_path / "s.labels"), None,
                str(tmp_path / "missing.labels")):
        assert_same(tsemantic3d.read_points_txt(str(tmp_path / "s.txt"), lab),
                    jsemantic3d.read_points_txt(str(tmp_path / "s.txt"), lab))


@pytest.mark.parametrize("with_labels", [True, False])
def test_semantic3d_to_big_blocks(with_labels):
    pts, labels = _scan()
    labels = labels if with_labels else None
    got = tsemantic3d.to_big_blocks(pts, labels, block_size=10.0,
                                    ds_stride=0.3)
    want = jsemantic3d.to_big_blocks(pts, labels, block_size=10.0,
                                     ds_stride=0.3)
    assert len(want) == 6
    assert_same(got, want)


@pytest.mark.parametrize("rotate", [True, False])
def test_semantic3d_sample_training_blocks(rotate):
    pts, labels = _scan()
    got, want = _both(jsemantic3d.sample_training_blocks,
                      tsemantic3d.sample_training_blocks, pts, labels,
                      seed=3, ds_stride=0.4, min_pn=64, rotate=rotate,
                      covar_nn_size=1.0)
    assert len(want) > 4 and want[0]["feats"].shape[1] == 13
    assert_same(got, want)


@pytest.mark.parametrize("model", ["train", "test"])
def test_semantic3d_blocks_from_pkl(tmp_path, model):
    """The port's read of a saved block pkl (loaded, then
    ``blocks_from_list``) equals the JAX ``blocks_from_pkl`` under the
    same seeded rng."""
    pts, labels = _scan(1)
    blocks = tsemantic3d.sample_training_blocks(
        pts, labels, ds_stride=0.4, min_pn=64, covar_nn_size=1.0,
        rng=np.random.RandomState(4))
    path = str(tmp_path / "scan.pkl")
    tsemantic3d.save_blocks(path, blocks)
    assert_same(tio.read_pkl(path), blocks)
    got = tsemantic3d.blocks_from_list(model, tio.read_pkl(path),
                                       rng=np.random.RandomState(5))
    want = jsemantic3d.blocks_from_pkl(model, path,
                                       rng=np.random.RandomState(5))
    assert len(want) == len(blocks)
    assert_same(got, want)


# -- batching and the Provider -----------------------------------------------

def test_batching_pad_block():
    rng = np.random.RandomState(9)
    for n in (60, 150):   # padded, then subsampled to 100
        args = (rng.randn(n, 3).astype(np.float32),
                rng.randn(n, 5).astype(np.float32),
                rng.randint(0, 13, n).astype(np.int32), 100)
        got, want = _both(jbatching.pad_block, tbatching.pad_block, *args,
                          seed=n)
        assert_same(got, want)
    assert_same(tbatching.pad_block(args[0], None, None, 200),
                jbatching.pad_block(args[0], None, None, 200))


@pytest.mark.parametrize("pad_masked", [False, True])
def test_batching_stack_blocks_fills_the_batch(pad_masked):
    rng = np.random.RandomState(10)
    blocks = [jbatching.pad_block(rng.randn(50, 3).astype(np.float32),
                                  rng.randn(50, 2).astype(np.float32),
                                  rng.randint(0, 5, 50).astype(np.int32), 64)
              for _ in range(3)]
    got, want = _both(jbatching.stack_blocks, tbatching.stack_blocks,
                      blocks, 5, seed=3, pad_masked=pad_masked)
    assert want["xyz"].shape == (5, 64, 3)
    assert_same(got, want)
    assert_same(tbatching.stack_blocks(blocks), jbatching.stack_blocks(blocks))


@pytest.mark.parametrize("model", ["train", "test"])
def test_provider_batches(room_pkl, tmp_path, model):
    """Two room files, batch 4, 2048 points: the same file order, block
    shuffles, subsamples and final partial batch as the JAX Provider."""
    files = list(room_pkl)
    out = {}
    for name, mod, s3 in (("j", jprovider, js3dis), ("t", tprovider,
                                                     ts3dis)):
        read_fn = functools.partial(s3.blocks_from_room_pkl, use_covars=True,
                                    rng=np.random.RandomState(4))
        prov = mod.Provider(files, model, 4, read_fn, 2048, seed=6)
        out[name] = list(prov)
        prov.close()
    blocks = sum(len(js3dis.read_pkl(f)["xyzs"]) for f in files)
    assert len(out["j"]) == -(-blocks // 4) >= 4
    assert_same(out["t"], out["j"])


@pytest.mark.parametrize("model", ["train", "test"])
def test_provider_raises_the_producers_error(room_pkl, model):
    """A read that fails in the producer thread is raised to the consumer
    after the batches before it, not taken for the end of the files."""
    files = list(room_pkl) + ["missing.pkl"]
    if model == "train":   # the shuffled order puts the bad file anywhere
        files = ["missing.pkl"]
    read_fn = functools.partial(ts3dis.blocks_from_room_pkl,
                                rng=np.random.RandomState(4))
    prov = tprovider.Provider(files, model, 4, read_fn, 2048, seed=6)
    got = []
    with pytest.raises(FileNotFoundError, match="missing.pkl"):
        for b in prov:
            got.append(b)
    blocks = sum(len(js3dis.read_pkl(f)["xyzs"]) for f in room_pkl)
    assert len(got) == (blocks // 4 if model == "test" else 0)
    assert not prov._thread.is_alive()
