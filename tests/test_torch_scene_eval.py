"""The rest of the port's scene eval against the JAX package: the device
interpolation (``ops.interpolate``, ``interpolate_to_dense``'s device
arm), the rotation ensemble, the Semantic3D submission writer, the
``--synthetic`` arms, ``--exact-search`` (``build_model(windowed=False)``
against the JAX program traced with ``PCS_DISABLE_WINDOWED=1``), and the
CLI from ``prepare_data semantic3d_test`` to ``.labels`` files on a crop
of the seeded outdoor scan.

Coordinates of the interpolation tests lie on a 1/1024 m lattice, where
every squared distance is exact, so the JAX program and the port select
the same neighbours (ROADMAP §3)."""
import importlib.util
import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from pointcloudsegmentation_tpu.data import native as jnative
from pointcloudsegmentation_tpu.data import semantic3d as jsemantic3d
from pointcloudsegmentation_tpu.data import toy as jtoy
from pointcloudsegmentation_tpu.eval import interpolate as jeval
from pointcloudsegmentation_tpu.ops import interpolate as jinterp
from pointcloudsegmentation_tpu.ops import morton as jmorton
from pointcloudsegmentation_tpu.ops import search as jsearch
from pointcloudsegmentation_tpu.train.config import s3dis_config as js3dis
from pointcloudsegmentation_tpu.train.model_zoo import build_model as jbuild
from pointcloudsegmentation_tpu_torch import interpolate as tcli
from pointcloudsegmentation_tpu_torch import prepare_data
from pointcloudsegmentation_tpu_torch.config import s3dis_config as ts3dis
from pointcloudsegmentation_tpu_torch.config import semantic3d_config
from pointcloudsegmentation_tpu_torch.convert import load_flax_params
from pointcloudsegmentation_tpu_torch.data import semantic3d as tsemantic3d
from pointcloudsegmentation_tpu_torch.data import synth_outdoor
from pointcloudsegmentation_tpu_torch.eval import interpolate as teval
from pointcloudsegmentation_tpu_torch.ops import interpolate as tinterp
from pointcloudsegmentation_tpu_torch.ops import search as tsearch
from pointcloudsegmentation_tpu_torch.train.checkpoint import \
    CheckpointManager
from pointcloudsegmentation_tpu_torch.train.loop import Trainer
from pointcloudsegmentation_tpu_torch.train.model_zoo import \
    build_model as tbuild

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LATTICE = 1024
N = 1024                       # points per block of the model tests
SEM_RATIO = teval.SEMANTIC3D_RATIO


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    """The JAX data functions take their native paths only where the
    JAX package's library is built."""
    jnative.ensure_built()
    assert jnative.available()


def read_pkl(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _lattice(a):
    return (np.round(np.asarray(a) * LATTICE) / LATTICE).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _support_queries(rng, ns, nq, c=8):
    """Support and query points on the lattice within 1.5 m (so that
    |q|^2 + |s|^2 stays exact in float32), some masked, one query far
    away; Dirichlet probabilities."""
    s = _lattice(rng.uniform(0, 1.5, (ns, 3)))
    q = _lattice(rng.uniform(0, 1.5, (nq, 3)))
    q[0] = _lattice([1.5, 1.5, 1.5])
    s[: ns // 10] = s[ns // 10: 2 * (ns // 10)]        # duplicates
    sm, qm = rng.rand(ns) < 0.9, rng.rand(nq) < 0.95
    qm[0] = True
    probs = rng.dirichlet(np.ones(c), ns).astype(np.float32)
    return s, sm, probs, q, qm


@pytest.mark.parametrize("ns,nq,k,chunk", [(3000, 2500, 8, 1024),
                                           (700, 300, 6, 128)])
def test_interpolate_probs_matches_jax(ns, nq, k, chunk):
    """Indices exact, probabilities within 1e-6; a masked query gets
    zeros."""
    s, sm, probs, q, qm = _support_queries(np.random.RandomState(ns), ns, nq)
    jidx, _, jvalid = [np.asarray(a) for a in jsearch.knn_in_support(
        q, qm, s, sm, k, chunk=chunk)]
    idx, _, valid = tsearch.knn_in_support(_t(q), _t(qm), _t(s), _t(sm), k,
                                           chunk=chunk)
    np.testing.assert_array_equal(valid.numpy(), jvalid)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    want = np.asarray(jinterp.interpolate_probs(s, sm, probs, q, qm, k=k,
                                                ratio=SEM_RATIO,
                                                chunk=chunk))
    got = tinterp.interpolate_probs(_t(s), _t(sm), _t(probs), _t(q), _t(qm),
                                    k=k, ratio=SEM_RATIO, chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == (nq, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert not got.numpy()[~qm].any()
    np.testing.assert_allclose(got.numpy()[qm].sum(1), 1.0, atol=1e-5)


def test_interpolate_to_dense_device_arm_matches_jax_and_native():
    """The device arm (``prefer_native=False``) within 1e-6 of JAX's
    device arm over three query chunks, and beside the native arm: argmax
    agreement and the largest probability difference, compared as the
    card's phase compares them (tie order may differ)."""
    rng = np.random.RandomState(7)
    s, _, probs, q, _ = _support_queries(rng, 2000, 5000)
    want = jeval.interpolate_to_dense(s, probs, q, k=8, ratio=SEM_RATIO,
                                      chunk=2000, prefer_native=False)
    got = teval.interpolate_to_dense(s, probs, q, k=8, ratio=SEM_RATIO,
                                     chunk=2000, prefer_native=False)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    native = teval.interpolate_to_dense(s, probs, q, k=8, ratio=SEM_RATIO)
    assert isinstance(native, np.ndarray)
    agree = (native.argmax(1) == got.numpy().argmax(1)).mean()
    assert agree >= 0.999, agree
    assert np.abs(native - got.numpy()).max() <= 1e-3


def test_device_arm_takes_the_native_neighbours_of_overlapping_blocks():
    """Support points as overlapping blocks give them: each point in
    several blocks, put back as (p - block min) + block min tens of metres
    out, so its copies lie an ulp apart (or on one another) with other
    probabilities.  The device arm's k-NN takes the native library's
    neighbours with its distances, and its probabilities are the native
    arm's."""
    rng = np.random.RandomState(5)
    base = (np.array([20.0, 25.0, 2.0]) + rng.uniform(0, 3, (1500, 3))
            ).astype(np.float32)
    copies = []
    for _ in range(4):
        bmin = rng.uniform(10, 30, 3).astype(np.float32)
        copies.append((base - bmin) + bmin)
    s = np.concatenate(copies).astype(np.float32)
    assert 0 < (s[:1500] != s[1500:3000]).any(1).mean() < 1
    probs = rng.dirichlet(np.ones(8), len(s)).astype(np.float32)
    q = (np.array([20.0, 25.0, 2.0]) + rng.uniform(0, 3, (2000, 3))
         ).astype(np.float32)
    hidx, hd2 = jnative.knn(s, q, 6, cell_hint=0.3)
    idx, d2 = tinterp.knn_exact(_t(q), _t(s), 6, chunk=256)
    np.testing.assert_array_equal(idx.numpy(), hidx)
    np.testing.assert_array_equal(d2.numpy(), hd2)
    native = teval.interpolate_to_dense(s, probs, q, k=6, ratio=SEM_RATIO)
    got = teval.interpolate_to_dense(s, probs, q, k=6, ratio=SEM_RATIO,
                                     chunk=700, prefer_native=False)
    np.testing.assert_allclose(got.numpy(), native, rtol=0, atol=1e-6)


def _fused_ties(rng, count):
    """(query, lower-index point, higher-index point) triples whose squared
    distances to the query round to one float32 value in the native
    library's fused form, where the plain float32 sum puts the
    higher-index point nearer."""
    f32 = lambda a: a.astype(np.float32).astype(np.float64)
    q = (np.array([20.0, 25.0, 2.0]) + rng.uniform(0, 1, 3)).astype(
        np.float32)
    p = (q + rng.uniform(-0.05, 0.05, (200_000, 3))).astype(np.float32)
    x, y, z = (p - q).astype(np.float64).T
    fused = f32(z * z + f32(x * x + f32(y * y)))
    plain = f32(f32(f32(x * x) + f32(y * y)) + f32(z * z))
    order = np.lexsort((plain, fused))
    same = np.nonzero((fused[order][1:] == fused[order][:-1])
                      & (plain[order][1:] != plain[order][:-1]))[0]
    assert len(same) >= count
    # the pair's point with the larger plain sum goes first (lower index)
    return [(q, p[order[i + 1]], p[order[i]]) for i in same[:count]]


def _grid_ties():
    """(support, query, k) where points at one distance from the query lie
    in other cells of the native library's 0.3 m grid: with k 1 the
    higher index is visited first and kept; with k 2 the nearest point,
    visited last, evicts the tied pair's higher index, which was visited
    first.  Coordinates are dyadic, so every distance is exact."""
    q = np.array([[20.5, 25.0, 2.0]], np.float32)
    first = np.array([[20.75, 25.0, 2.0], [20.25, 25.0, 2.0]], np.float32)
    evict = np.array([[20.5, 25.5, 2.0], [20.75, 25.0, 2.0],
                      [20.0, 25.0, 2.0]], np.float32)
    return [(first, q, 1), (evict, q, 2)]


def _many_copies():
    """(support, query, k): 40 copies of one point behind 5 farther ones,
    more than the device arm's first window of 32 candidates holds."""
    q = np.array([[20.5, 25.0, 2.0]], np.float32)
    far = q + np.arange(1, 6, dtype=np.float32)[:, None] * np.float32(0.25)
    near = np.repeat(q + np.float32(0.125), 40, 0)
    return np.concatenate([far, near]).astype(np.float32), q, 6


def test_device_arm_breaks_distance_ties_as_the_native_library():
    """Points at one fused distance from the query: in one grid cell both
    arms take the lower index, also where the plain float32 sum (the
    device arm's candidate score) ranks the other first, and with more
    copies than its first window; across cells the device arm replays the
    library's visiting order and heap."""
    cases = [(np.stack([low, high]), q[None], 1)
             for q, low, high in _fused_ties(np.random.RandomState(9), 8)]
    for s, q, k in cases + _grid_ties() + [_many_copies()]:
        hidx, hd2 = jnative.knn(s, q, k, cell_hint=0.3)
        idx, d2 = tinterp.knn_exact(_t(q), _t(s), k)
        np.testing.assert_array_equal(idx.numpy(), hidx)
        np.testing.assert_array_equal(d2.numpy(), hd2)
    assert [jnative.knn(s, q, k, cell_hint=0.3)[0].tolist()
            for s, q, k in _grid_ties()] == [[[1]], [[1, 0]]]
    assert all(jnative.knn(s, q, 1, cell_hint=0.3)[0][0, 0] == 0
               for s, q, _ in cases)


def test_semantic3d_writer_matches_jax_with_the_zero_column(tmp_path):
    """argmax + 1 over the port's 8 columns writes what the JAX writer
    writes given a zero unlabeled column in front (ties included)."""
    rng = np.random.RandomState(0)
    probs = rng.dirichlet(np.ones(8), 500).astype(np.float32)
    probs[:5] = 1.0 / 8                                  # ties: first wins
    got = teval.save_semantic3d_labels(str(tmp_path / "port.labels"), probs)
    want = jeval.save_semantic3d_labels(
        str(tmp_path / "jax.labels"),
        np.concatenate([np.zeros((500, 1), np.float32), probs], 1))
    np.testing.assert_array_equal(got, want)
    text = open(tmp_path / "port.labels").read()
    assert text == open(tmp_path / "jax.labels").read()
    assert text.split() == [str(p) for p in want] and set(want) <= set(
        range(1, 9))


@pytest.fixture(scope="module")
def jax_script():
    """``scripts/interpolate.py`` as a module, for its block helpers."""
    spec = importlib.util.spec_from_file_location(
        "jax_interpolate_script", os.path.join(ROOT, "scripts",
                                               "interpolate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _blocks(n, count):
    rng = np.random.RandomState(0)
    out = []
    for i in range(count):
        b = jtoy.synthetic_room_block(rng, n=n)
        mask = np.ones(n, bool)
        mask[-17 * (i + 1):] = False
        out.append({"xyz": b["xyz"], "feats": b["feats"], "mask": mask,
                    "labels": b["labels"],
                    "block_min": np.array([3.0 * i, 0, 0], np.float32)})
    return out


def test_synthetic_arms_match_the_jax_script(jax_script):
    """``rotate_block`` and ``add_synthetic_extras`` give the JAX
    script's arrays (the context features cut to ``CTX_FEAT_DIM``
    columns: the port's ``ContextNet`` has a fixed input width)."""
    keys = ("dense_xyz", "ctx_xyz")
    blocks = {}
    for name, mod in (("jax", jax_script), ("port", tcli)):
        rng = np.random.RandomState(3)
        bs = [dict(b) for b in _blocks(256, 2)]
        for b in bs:
            mod.add_synthetic_extras(b, keys, rng)
        blocks[name] = [mod.rotate_block(b, np.pi / 12 * 2) for b in bs]
    for w, g in zip(blocks["jax"], blocks["port"]):
        assert g.keys() == w.keys()
        for key in w:
            want = w[key][:, :4] if key == "ctx_feats" else w[key]
            np.testing.assert_array_equal(g[key], want, err_msg=key)


@pytest.fixture(scope="module")
def exact_program():
    """One JAX program: ``tiny_s3dis`` at 1024 points traced with
    ``PCS_DISABLE_WINDOWED=1`` (the JAX scene eval's ``--exact-search``),
    run over a rotation ensemble of two arms and on one block; the port's
    float32 model with the converted weights and ``windowed=False``."""
    blocks = _blocks(N, 2)
    b0 = blocks[0]
    arms = [(0.0, blocks),
            (np.pi / 12, [tcli.rotate_block(b, np.pi / 12) for b in blocks])]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PCS_DISABLE_WINDOWED", "1")
        jmodel = jbuild(js3dis(model="tiny_s3dis", data_num_points=N,
                               data_caps=(N // 2, N // 8)), search_chunk=512)
        params = jmodel.init(jax.random.PRNGKey(0), b0["xyz"], b0["feats"],
                             b0["mask"], False)
        params = jax.tree_util.tree_map(np.array, params)
        apply_fn = jax.jit(lambda p, x, f, m: jmodel.apply(p, x, f, m,
                                                            False))
        jarms = [(np.asarray(x), np.asarray(p)) for x, p in
                 jeval.eval_rot_ensemble_probs(apply_fn, params, arms)]
        jlogits = np.asarray(apply_fn(params, b0["xyz"], b0["feats"],
                                      b0["mask"]))
    models = {}
    for windowed in (False, True):
        m = tbuild(ts3dis(model="tiny_s3dis", compute_dtype="float32",
                          data_num_points=N, data_caps=(N // 2, N // 8)),
                   device="cpu", search_chunk=512, windowed=windowed)
        models[windowed] = load_flax_params(m, params).eval()
    return models, arms, jarms, jlogits


def test_rot_ensemble_matches_jax(exact_program):
    """Each arm's sampled points back in the original frame (equal) and
    its probabilities (within 1e-5) as JAX's ``eval_rot_ensemble_probs``
    gives them."""
    models, arms, jarms, _ = exact_program
    got = list(teval.eval_rot_ensemble_probs(models[False], arms))
    assert len(got) == 2
    for (sxyz, probs), (jxyz, jprobs) in zip(got, jarms):
        np.testing.assert_array_equal(sxyz, jxyz)
        np.testing.assert_allclose(probs, jprobs, rtol=0, atol=1e-5)
    # the inverse rotation puts arm 1's points back onto arm 0's
    np.testing.assert_allclose(got[1][0], got[0][0], rtol=0, atol=1e-5)


def test_exact_search_logits_match_jax(exact_program):
    """``windowed=False`` against the JAX program traced with
    ``PCS_DISABLE_WINDOWED=1``; the windowed model gives other logits, so
    the flag reaches the search."""
    models, arms, _, jlogits = exact_program
    b0 = arms[0][1][0]
    with torch.inference_mode():
        logits = {w: m(_t(b0["xyz"]), _t(b0["feats"]), _t(b0["mask"]))
                  .numpy() for w, m in models.items()}
    scale = max(1.0, float(np.abs(jlogits).max()))
    np.testing.assert_allclose(logits[False] / scale, jlogits / scale,
                               rtol=0, atol=1e-4)
    assert np.abs(logits[True] - logits[False]).max() > 1e-3


def test_band_neighbors_auto_exact_matches_jax(monkeypatch):
    """``band_neighbors_auto(windowed=False)`` on a Morton-sorted block
    takes the global search, slot for slot as JAX does with the variable
    set."""
    rng = np.random.RandomState(2)
    xyz = rng.uniform(0, 3, (N, 3)).astype(np.float32)
    mask = np.ones(N, bool)
    mask[-50:] = False
    xyz, mask, _ = [np.asarray(a) for a in
                    jmorton.sort_block(xyz, mask, 0.0375, 3.0)[:3]]
    bands = ((0.0, 0.2, 16),)
    monkeypatch.setenv("PCS_DISABLE_WINDOWED", "1")
    (want,) = jsearch.band_neighbors_auto(xyz, mask, bands, cand_k=64,
                                          sorted=True, ov_pool_size=0)
    (got,) = tsearch.band_neighbors_auto(_t(xyz), _t(mask), bands, cand_k=64,
                                         sorted=True, windowed=False)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    (win,) = tsearch.band_neighbors_auto(_t(xyz), _t(mask), bands,
                                         cand_k=64, sorted=True)
    assert hasattr(win, "lidx")


def test_exact_search_reaches_the_ecd_encoders(monkeypatch):
    """An ECD net built with ``windowed=False`` never calls the windowed
    search; built as usual it does."""
    cfg = ts3dis(model="ecd_s3dis", compute_dtype="float32",
                 data_num_points=N, data_caps=(N // 2, N // 8))
    b = _blocks(N, 1)[0]

    def windowed_search(*args, **kw):
        raise AssertionError("windowed search called")

    monkeypatch.setattr(tsearch, "windowed_multi_band_neighbors",
                        windowed_search)
    for windowed in (False, True):
        m = tbuild(cfg, torch.Generator().manual_seed(0), "cpu",
                   windowed=windowed).eval()
        run = lambda: m(_t(b["xyz"]), _t(b["feats"]), _t(b["mask"]))
        if windowed:
            with pytest.raises(AssertionError, match="windowed search"):
                run()
        else:
            with torch.inference_mode():
                assert torch.isfinite(run()).all()


# -- the CLI: prep -> scene eval -> .labels -----------------------------------

@pytest.fixture(scope="module")
def scan(tmp_path_factory):
    """A 12 x 12 m crop of the seeded outdoor scan as a test scan (no
    .labels), prepared with ``semantic3d_test --rotations 1``; a
    checkpoint of random weights per model key at 1024 points."""
    root = tmp_path_factory.mktemp("scan")
    pts, _ = synth_outdoor.outdoor_scan(0)
    crop = pts[(pts[:, 0] < 12) & (pts[:, 1] < 12)]
    tsemantic3d.write_points_txt(str(root / "raw" / "crop.txt"), crop)
    prepare_data.main(["semantic3d_test", "--raw-dir", str(root / "raw"),
                       "--out-dir", str(root / "prep"), "--rotations", "1",
                       "--workers", "1"])
    for key in ("pointnet_semantic3d", "dense_semantic3d",
                "context_semantic3d"):
        cfg = semantic3d_config(model=key, data_num_points=N,
                                data_caps=(N // 2, N // 8))
        trainer = Trainer(cfg, device="cpu")
        ck = CheckpointManager(str(root / "ck" / key))
        ck.save(0, trainer.init_state(torch.Generator().manual_seed(0)))
        ck.close()
    return root, len(crop)


def _eval(root, key, out, *extra):
    return tcli.main(["--config", "semantic3d", "--model", key,
                      "--num-points", str(N), "--device", "cpu",
                      "--checkpoint-dir", str(root / "ck" / key),
                      "--scene-dir", str(root / "prep" / "test"),
                      "--out-dir", str(out), *extra])


def _check_labels(path, n):
    labels = np.loadtxt(path, dtype=np.int64, ndmin=1)
    assert labels.shape == (n,)
    assert labels.min() >= 1 and labels.max() <= 8
    return labels


def test_cli_labels_every_scan_point_with_the_rotation_ensemble(scan,
                                                                tmp_path):
    """prep ``semantic3d_test --rotations 1`` -> scene eval
    ``--rot-ensemble 1 --labels-out``: one label in 1..8 per scan point,
    in the scan's order (not one per block point), ``miou`` null for a
    scan without labels; each arm swept from its own pkl."""
    root, n = scan
    res, = _eval(root, "pointnet_semantic3d", tmp_path / "native",
                 "--rot-ensemble", "1", "--labels-out")
    labels = _check_labels(tmp_path / "native" / "crop.labels", n)
    assert res["res"] is None and res["points"] == n
    arms = [read_pkl(root / "prep" / sub / "crop.pkl")
            for sub in ("test", "test_1")]
    assert res["blocks"] == [len(a["xyzs"]) for a in arms]
    assert sum(len(x) for x in arms[0]["xyzs"]) != n
    np.testing.assert_array_equal(labels, res["probs"].argmax(1) + 1)
    np.testing.assert_allclose(res["probs"].sum(1), 1.0, atol=1e-3)
    saved, = json.load(open(tmp_path / "native" / "scene_eval.json"))
    assert saved["miou"] is None and saved["points"] == n


@pytest.mark.parametrize("key", ["dense_semantic3d", "context_semantic3d"])
def test_cli_evaluates_the_dense_and_context_scenes(scan, tmp_path, key):
    """The dense model reads each block's dense cloud and the context
    model its window of the scene's context cloud, built from the scene
    pkl at load time; both label every scan point."""
    root, n = scan
    res, = _eval(root, key, tmp_path, "--rot-ensemble", "1", "--labels-out",
                 "--exact-search")
    _check_labels(tmp_path / "crop.labels", n)
    assert np.isfinite(res["probs"]).all()
    np.testing.assert_allclose(res["probs"].sum(1), 1.0, atol=1e-3)


def test_context_scene_blocks_match_jax_prepare_context_scene(scan,
                                                             tmp_path):
    """``eval_scene_blocks(context=True)`` gives each block of a scene pkl
    the context window, features and indices that the JAX
    ``prepare_context_scene`` gives the same blocks of the same unrotated
    scan, the pkl holding those blocks and JAX's context cloud."""
    root, _ = scan
    points, _ = prepare_data.read_scan(str(root / "raw" / "crop.txt"))
    want = jsemantic3d.prepare_context_scene(
        points, np.zeros(len(points), np.int32), stride=2.5, min_pn=128,
        rng=np.random.RandomState(0), rotate=False)
    assert len(want) > 1
    path = str(tmp_path / "crop.pkl")
    tsemantic3d.save_eval_scene(path, want,
                                jsemantic3d.context_cloud(points))
    got = tsemantic3d.eval_scene_blocks(read_pkl(path), context=True)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for key in ("xyz", "feats", "block_min", "ctx_xyz", "ctx_feats",
                    "ctx_idx"):
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def test_cli_refuses_a_missing_arm_and_a_scene_without_scan_points(scan,
                                                                   tmp_path):
    root, _ = scan
    with pytest.raises(FileNotFoundError, match="rotation arm 2"):
        _eval(root, "pointnet_semantic3d", tmp_path, "--rot-ensemble", "2")
    # the JAX layout has no scan points: nothing to label
    blocks = tsemantic3d.eval_scene_blocks(
        read_pkl(root / "prep" / "test" / "crop.pkl"))
    jdir = tmp_path / "jax_scene"
    jsemantic3d.save_eval_scene(str(jdir / "crop.pkl"), blocks)
    with pytest.raises(KeyError, match="scan_xyz"):
        tcli.main(["--config", "semantic3d", "--num-points", str(N),
                   "--device", "cpu", "--checkpoint-dir",
                   str(root / "ck" / "pointnet_semantic3d"), "--scene-dir",
                   str(jdir), "--out-dir", str(tmp_path / "out")])
