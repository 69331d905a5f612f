"""The port's offline prep CLI (``python -m
pointcloudsegmentation_tpu_torch.prepare_data``) against the JAX package's
library functions: for each of the six modes the pkls it writes equal what
the JAX functions give for the same file under ``RandomState(zlib.crc32(
basename))``, its output does not depend on ``--workers``, and the
z-offset map and the ScanNet class weights equal the JAX package's."""
import os
import pickle
import zlib

import numpy as np
import pytest

from pointcloudsegmentation_tpu.data import augment as jaugment
from pointcloudsegmentation_tpu.data import io_util as jio
from pointcloudsegmentation_tpu.data import modelnet as jmodelnet
from pointcloudsegmentation_tpu.data import native as jnative
from pointcloudsegmentation_tpu.data import s3dis as js3dis
from pointcloudsegmentation_tpu.data import scannet as jscannet
from pointcloudsegmentation_tpu.data import semantic3d as jsemantic3d
from pointcloudsegmentation_tpu_torch import prepare_data
from pointcloudsegmentation_tpu_torch.data import io_util as tio
from pointcloudsegmentation_tpu_torch.data import semantic3d as tsemantic3d
from pointcloudsegmentation_tpu_torch.data import synth_outdoor, synth_rooms

# each mode's extra flags in the comparison run
FLAGS = {"s3dis": ["--augment-geometry"], "scannet": ["--augment-geometry"],
         "semantic3d": [], "semantic3d_context": [],
         "semantic3d_test": ["--rotations", "1"], "modelnet40": []}


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    """The JAX package takes its native paths only where its library is
    built; build it so both packages take the same branches."""
    jnative.ensure_built()
    assert jnative.available()


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """Raw inputs of every mode, two files each: crops of the seeded
    outdoor scan (one with labels), synthetic rooms, ScanNet-like scenes
    and ModelNet-like clouds."""
    root = tmp_path_factory.mktemp("raw")
    dirs = {}
    pts, lab = synth_outdoor.outdoor_scan(0)
    sem = root / "semantic3d"
    sem.mkdir()
    a = (pts[:, 0] < 11) & (pts[:, 1] < 11)
    b = (pts[:, 0] > 11) & (pts[:, 1] > 16)
    tsemantic3d.write_points_txt(str(sem / "scan_a.txt"), pts[a], lab[a])
    tsemantic3d.write_points_txt(str(sem / "scan_b.txt"), pts[b])
    dirs["semantic3d"] = sem
    rooms, scenes, clouds = root / "rooms", root / "scannet", root / "mn"
    for d in (rooms, scenes, clouds):
        d.mkdir()
    for i in range(2):
        rng = np.random.RandomState(i)
        points, labels = synth_rooms.synthetic_s3dis_room(rng)
        tio.save_room_pkl(str(rooms / f"room_{i}.pkl"), points, labels)
        tio.save_pkl(str(scenes / f"scene_{i}.pkl"),
                     (points[:, :3], rng.randint(0, 21, len(points))))
        tio.save_pkl(str(clouds / f"part_{i}.pkl"),
                     [(rng.randn(300, 3).astype(np.float32) * 0.3, c)
                      for c in range(3)])
    dirs.update(s3dis=rooms, scannet=scenes, modelnet40=clouds)
    dirs["semantic3d_context"] = dirs["semantic3d_test"] = sem
    return dirs


@pytest.fixture(scope="module")
def prepared(raw, tmp_path_factory):
    """mode -> (out dir, [(raw path, output path), ...]) of the port's CLI
    with one worker."""
    out = {}
    for mode, flags in FLAGS.items():
        d = tmp_path_factory.mktemp(mode)
        res = prepare_data.main([mode, "--raw-dir", str(raw[mode]),
                                 "--out-dir", str(d), "--workers", "1"]
                                + flags)
        files = sorted(str(p) for p in raw[mode].iterdir()
                       if p.suffix in (".txt", ".pkl"))
        out[mode] = (d, list(zip(files, [r[0] for r in res])))
    return out


def rng_of(path):
    return np.random.RandomState(zlib.crc32(os.path.basename(path).encode()))


def read(path):
    with open(path, "rb") as f:
        return pickle.load(f)


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


def jax_scan(path):
    labels_path = os.path.splitext(path)[0] + ".labels"
    points, labels = jsemantic3d.read_points_txt(path, labels_path)
    return points, (np.zeros(len(points), np.int32) if labels is None
                    else labels)


def jax_output(mode, path, tmp_path):
    """What the JAX library functions write for ``path``: the object in
    the pkl (for ``semantic3d_test`` one per arm)."""
    rng = rng_of(path)
    tmp = str(tmp_path / "jax.pkl")
    if mode == "s3dis":
        points, labels = jio.read_room_pkl(path)
        js3dis.save_pkl(tmp, js3dis.prepare_room(points, labels, rng=rng,
                                                 augment_geometry=True))
    elif mode == "scannet":
        data = jio.read_pkl(path)
        jio.save_pkl(tmp, jscannet.prepare_scene(
            np.asarray(data[0], np.float32), np.asarray(data[1], np.int32),
            rng=rng, augment_geometry=True))
    elif mode in ("semantic3d", "semantic3d_context"):
        fn = jsemantic3d.sample_training_blocks if mode == "semantic3d" \
            else jsemantic3d.prepare_context_scene
        jsemantic3d.save_blocks(tmp, fn(*jax_scan(path), rng=rng))
    elif mode == "modelnet40":
        jio.save_pkl(tmp, [(jmodelnet.prepare_cloud(
            np.asarray(x, np.float32), int(l)), int(l))
            for x, l in jio.read_pkl(path)])
    else:
        points, _ = jsemantic3d.read_points_txt(path)
        macro = jsemantic3d.presample_test_blocks(points)
        arms = []
        for ri in range(2):
            blocks = [b for m in macro for b in
                      jsemantic3d.process_test_blocks(m, np.pi / 12 * ri)]
            jsemantic3d.save_eval_scene(tmp, blocks)
            arms.append(read(tmp))
        return arms
    return read(tmp)


@pytest.mark.parametrize("mode", sorted(FLAGS))
def test_prep_mode_gives_the_jax_functions_output(mode, prepared, tmp_path):
    out_dir, pairs = prepared[mode]
    assert len(pairs) == 2
    for path, out in pairs:
        want = jax_output(mode, path, tmp_path)
        if mode != "semantic3d_test":
            assert_same(read(out), want)
            continue
        # the JAX columns of both arms, then the port's three
        points, labels = jax_scan(path)
        stem = os.path.basename(out)
        for ri, jarm in enumerate(want):
            got = read(os.path.join(out_dir, "test" if ri == 0 else
                                    f"test_{ri}", stem))
            assert_same({k: got[k] for k in jarm}, jarm)
            if ri:              # the scan's own points: arm 0's pkl alone
                assert "scan_xyz" not in got and "scan_labels" not in got
            else:
                np.testing.assert_array_equal(got["scan_xyz"],
                                              points[:, :3])
                assert got["scan_labels"].dtype == np.int32
                np.testing.assert_array_equal(got["scan_labels"], labels)
            rotated = points.copy()
            rotated[:, :3] = jaugment.rotate_z(
                np.ascontiguousarray(points[:, :3]), np.pi / 12 * ri)
            assert_same(got["ctx_cloud"], jsemantic3d.context_cloud(rotated))


def test_semantic3d_test_keeps_every_scan_point_and_its_labels(prepared):
    """The eval scene holds the scan's points in file order and its labels
    where the .labels file exists (scan_a), zeros where not (scan_b)."""
    out_dir, pairs = prepared["semantic3d_test"]
    (a, out_a), (b, out_b) = pairs
    sa, sb = read(out_a), read(out_b)
    assert (sa["scan_labels"] > 0).any() and not sb["scan_labels"].any()
    assert len(sa["scan_xyz"]) == len(np.loadtxt(a, ndmin=2))
    assert len(sa["xyzs"]) > 0 and len(sb["xyzs"]) > 0


def test_workers_write_the_same_bytes(raw, tmp_path):
    """The seed comes from the file's basename, so two worker processes
    write what one writes, byte for byte (the JAX script's salted
    ``hash(path)`` seed makes every run differ)."""
    got = {}
    for workers in (1, 2):
        d = tmp_path / f"w{workers}"
        prepare_data.main(["semantic3d", "--raw-dir", str(raw["semantic3d"]),
                           "--out-dir", str(d), "--workers", str(workers)])
        got[workers] = {p.name: p.read_bytes() for p in d.iterdir()}
    assert sorted(got[1]) == ["scan_a.pkl", "scan_b.pkl"]
    assert got[1] == got[2]


def test_offset_z_map_equals_jax(raw, tmp_path):
    path = str(tmp_path / "offset_z.txt")
    prepare_data.main(["semantic3d", "--raw-dir", str(raw["semantic3d"]),
                       "--out-dir", str(tmp_path / "out"), "--workers", "1",
                       "--offset-z-map", path])
    files = sorted(str(p) for p in raw["semantic3d"].glob("*.txt"))
    want = str(tmp_path / "jax.txt")
    jsemantic3d.write_offset_z_map(want, [
        (os.path.splitext(os.path.basename(f))[0],
         jsemantic3d.read_points_txt(f)[0]) for f in files])
    assert open(path).read() == open(want).read()
    got = tsemantic3d.read_offset_z_map(path)
    assert got == jsemantic3d.read_offset_z_map(want)
    assert sorted(got) == ["scan_a", "scan_b"]


def test_scannet_weights_and_counts_equal_jax(prepared):
    out_dir, pairs = prepared["scannet"]
    counts = 0
    for _, out in pairs:
        scene = read(out)
        want = np.bincount(np.concatenate([np.ravel(l)
                                           for l in scene["lbls"]]),
                           minlength=jscannet.NUM_CLASSES + 1)
        got = np.load(out + ".counts.npy")
        np.testing.assert_array_equal(got, want)
        counts = counts + want
    want = str(out_dir / "jax_weights.txt")
    np.savetxt(want, jscannet.class_weights_from_counts(counts[1:]))
    assert open(out_dir / "scannet_weights.txt").read() == open(want).read()


def test_raw_dir_without_inputs_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match=r"\*\.txt"):
        prepare_data.main(["semantic3d_test", "--raw-dir", str(tmp_path),
                           "--out-dir", str(tmp_path / "out")])
