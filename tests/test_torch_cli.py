"""The port's user entry points on the CPU: the train CLI against the JAX
CLI's config and LR, a ``tiny_s3dis`` run that checkpoints and writes the
JAX CLI's metrics record, ``--restore --eval`` reproducing the epoch's test
metrics, training from prepared room pkls, the feature ablations against
the JAX CLI's, the scene eval on synthetic blocks and on a prepared room
(with the 12-feature checkpoint), and one epoch of both arms of the
training-curve run; ``--config semantic3d`` on Semantic3D block pkls, the
scene eval's refusal of it, and its ignore label against the JAX
preset's."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from pointcloudsegmentation_tpu.train import cli as jcli
from pointcloudsegmentation_tpu.train.config import \
    semantic3d_config as jsemantic3d_config
from pointcloudsegmentation_tpu.train.loop import Trainer as JTrainer
from pointcloudsegmentation_tpu.train.loop import \
    seg_loss_terms as jseg_loss_terms
from pointcloudsegmentation_tpu_torch import interpolate, parity_ab
from pointcloudsegmentation_tpu_torch.config import semantic3d_config
from pointcloudsegmentation_tpu_torch.data import (s3dis, semantic3d,
                                                   synth_rooms)
from pointcloudsegmentation_tpu_torch.train import cli
from pointcloudsegmentation_tpu_torch.train.loop import seg_loss_terms

torch.set_num_threads(1)

JAX_RECORD_KEYS = {"epoch", "train_loss", "lr", "miou", "oiou", "oacc",
                   "iou", "acc", "points_per_sec"}
TINY = ["--config", "s3dis", "--synthetic", "--model", "tiny_s3dis",
        "--num-points", "512", "--batch-size", "2", "--steps-per-epoch",
        "2", "--device", "cpu"]


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("argv", [
    ["--config", "s3dis"],
    ["--config", "s3dis", "--model", "tiny_s3dis", "--epochs", "3",
     "--num-points", "2048", "--lr-init", "0.004", "--steps-per-epoch",
     "7", "--checkpoint-dir", "ck"],
    ["--config", "scannet", "--epochs", "2", "--num-points", "4096"],
])
def test_build_cfg_matches_jax(argv):
    got = cli.build_cfg(cli.parse_args(argv))
    want = jcli.build_cfg(jcli.parse_args(argv))
    for name, value in _fields(got).items():
        if dataclasses.is_dataclass(value):
            assert _fields(value) == _fields(getattr(want, name)), name
        else:
            assert value == getattr(want, name), name


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One epoch of 2 steps of ``tiny_s3dis`` on the CPU with checkpoints
    and a metrics file."""
    d = tmp_path_factory.mktemp("cli")
    argv = TINY + ["--epochs", "1", "--lr-init", "0.002",
                   "--checkpoint-dir", str(d / "ck"),
                   "--metrics-file", str(d / "train.jsonl")]
    state = cli.main(argv)
    return d, argv, state


def test_cli_trains_checkpoints_and_writes_metrics(trained):
    d, argv, state = trained
    assert state.step == 2
    assert (d / "ck" / "epoch_000000.pt").exists()
    assert (d / "ck" / "best" / "epoch_000000.pt").exists()
    rec, = [json.loads(line) for line in open(d / "train.jsonl")]
    assert set(rec) == JAX_RECORD_KEYS
    assert rec["epoch"] == 0 and np.isfinite(rec["train_loss"])
    assert 0.0 <= rec["miou"] <= 1.0 and len(rec["iou"]) == 13
    assert rec["points_per_sec"] > 0
    # the LR the JAX trainer reads at the epoch's first step
    jargv = [a for a in argv if a not in ("--device", "cpu")]
    jcfg = jcli.build_cfg(jcli.parse_args(jargv))
    assert _fields(jcfg.optim) == _fields(
        cli.build_cfg(cli.parse_args(argv)).optim)
    assert rec["lr"] == JTrainer(jcfg).lr_at(0)
    assert rec["lr"] == np.float32(0.002)


def test_cli_restore_eval_reproduces_the_test_metrics(trained):
    d, argv, _ = trained
    res = cli.main(argv[:-2] + ["--restore", "--eval", "--metrics-file",
                                str(d / "eval.jsonl")])
    rec, = [json.loads(line) for line in open(d / "train.jsonl")]
    ev, = [json.loads(line) for line in open(d / "eval.jsonl")]
    assert ev["epoch"] == -1 and ev["split"] == "eval"
    for key in ("miou", "oiou", "oacc", "iou", "acc"):
        assert ev[key] == rec[key], key
    assert float(res["miou"]) == rec["miou"]


@pytest.fixture(scope="module")
def room_dirs(tmp_path_factory):
    """A synthetic room prepared into a train dir (its first 4 blocks) and
    another into a test dir (its first 2)."""
    d = tmp_path_factory.mktemp("rooms")
    for split, seed, blocks in (("train", 3, 4), ("test", 4, 2)):
        points, labels = synth_rooms.synthetic_s3dis_room(
            np.random.RandomState(seed))
        prep = s3dis.prepare_room(points, labels,
                                  rng=np.random.RandomState(seed))
        s3dis.save_pkl(str(d / split / f"room{seed}.pkl"),
                       {k: v[:blocks] for k, v in prep.items()})
    return d


def _data_argv(room_dirs, *extra):
    return ["--config", "s3dis", "--model", "tiny_s3dis", "--num-points",
            "512", "--batch-size", "2", "--data-dir",
            str(room_dirs / "train"), "--test-data-dir",
            str(room_dirs / "test"), *extra]


def test_cli_trains_from_prepared_room_pkls(room_dirs, tmp_path):
    """The Provider over room pkls (rgb and covariance features) feeds an
    epoch of the CLI, which checkpoints and writes the JAX CLI's record."""
    argv = _data_argv(room_dirs, "--epochs", "1", "--device", "cpu",
                      "--checkpoint-dir", str(tmp_path / "ck"),
                      "--metrics-file", str(tmp_path / "m.jsonl"))
    state = cli.main(argv)
    assert state.step == 2   # 4 blocks, 2 a step
    assert (tmp_path / "ck" / "epoch_000000.pt").exists()
    rec, = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    assert set(rec) == JAX_RECORD_KEYS
    assert rec["epoch"] == 0 and np.isfinite(rec["train_loss"])
    assert 0.0 <= rec["miou"] <= 1.0 and len(rec["iou"]) == 13


def test_cli_provider_batches_per_epoch(room_dirs):
    """The test batches equal the JAX CLI's; the train Provider is seeded
    with the epoch number (the JAX CLI seeds every epoch 0), so epoch 0
    shuffles and subsamples as the JAX CLI does and epoch 1 differently.
    Train labels are compared: the color jitter draws from an unseeded
    stream in both packages."""
    argv = _data_argv(room_dirs)
    args = cli.parse_args(argv)
    cfg = cli.build_cfg(args)
    jargs = jcli.parse_args(argv)
    jcfg = jcli.build_cfg(jargs)
    got = list(cli.make_batches(cfg, args, "test", 2)(1))
    want = list(jcli.make_batches(jcfg, jargs, "test", 2)())
    assert len(got) == len(want) == 1
    for g, w in zip(got, want):
        assert g["feats"].shape == (2, 512, 12)
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    train = cli.make_batches(cfg, args, "train", 2)
    labels = [np.stack([b["labels"] for b in train(e)]) for e in (0, 1)]
    jlabels = np.stack([b["labels"] for b in
                        jcli.make_batches(jcfg, jargs, "train", 2)()])
    np.testing.assert_array_equal(labels[0], jlabels)
    assert not np.array_equal(labels[1], labels[0])


@pytest.mark.parametrize("mode", ["none", "zero", "drop-rgb",
                                  "drop-covars"])
def test_cli_ablate_feats_matches_jax(mode):
    """``--ablate-feats`` gives the JAX CLI's batches (12 features: rgb
    and covariances)."""
    argv = ["--config", "s3dis", "--synthetic", "--num-points", "256",
            "--steps-per-epoch", "2", "--ablate-feats", mode]
    args = cli.parse_args(argv)
    jargs = jcli.parse_args(argv)
    got = list(cli.make_batches(cli.build_cfg(args), args, "train", 2)(0))
    want = list(jcli.make_batches(jcli.build_cfg(jargs), jargs, "train",
                                  2)())
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["feats"].shape == (2, 256, 12)
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    feats = got[0]["feats"]
    zeroed = {"none": [], "zero": range(12), "drop-rgb": range(3),
              "drop-covars": range(3, 12)}[mode]
    for col in range(12):
        assert (feats[..., col] == 0).all() == (col in zeroed), col


def test_scene_eval_synthetic(tmp_path):
    out = interpolate.main(["--synthetic", "--model", "tiny_s3dis",
                            "--num-points", "512", "--device", "cpu",
                            "--out-dir", str(tmp_path)])
    r, = out
    assert r["points"] == 4 * 512
    assert np.isfinite(r["probs"]).all()
    np.testing.assert_allclose(r["probs"].sum(1), 1.0, atol=1e-3)
    assert 0.0 <= r["res"]["miou"] <= 1.0
    saved, = json.load(open(tmp_path / "scene_eval.json"))
    assert saved["miou"] == float(r["res"]["miou"])


def test_scene_eval_restores_the_12_feature_checkpoint(trained, tmp_path):
    """A prepared room's blocks get rgb and covariance features, as the
    training read_fn gives them, so the checkpoint trained with
    feat_dim=12 restores and labels the room."""
    d, _, _ = trained
    points, labels = synth_rooms.synthetic_s3dis_room(
        np.random.RandomState(3))
    prep = s3dis.prepare_room(points, labels, rng=np.random.RandomState(3))
    s3dis.save_pkl(str(tmp_path / "scenes" / "room0.pkl"), prep)
    blocks = interpolate.load_blocks(
        str(tmp_path / "scenes" / "room0.pkl"),
        cli.build_cfg(cli.parse_args(TINY)), "s3dis",
        np.random.RandomState(0))
    assert len(blocks) == len(prep["xyzs"])
    assert blocks[0]["feats"].shape == (512, 12)
    out = interpolate.main(["--config", "s3dis", "--model", "tiny_s3dis",
                            "--num-points", "512", "--device", "cpu",
                            "--checkpoint-dir", str(d / "ck"),
                            "--scene-dir", str(tmp_path / "scenes"),
                            "--out-dir", str(tmp_path / "out")])
    r, = out
    assert r["name"] == "room0" and r["points"] == 512 * len(blocks)
    assert np.isfinite(r["probs"]).all()
    np.testing.assert_allclose(r["probs"].sum(1), 1.0, atol=1e-3)
    assert 0.0 <= r["res"]["miou"] <= 1.0


def test_parity_ab_one_epoch(tmp_path):
    out = tmp_path / "curve.json"
    res = parity_ab.main(["--train-rooms", "1", "--test-rooms", "1",
                          "--epochs", "1", "--num-points", "512",
                          "--model", "tiny_s3dis", "--device", "cpu",
                          "--out", str(out)])
    saved = json.load(open(out))
    assert saved == json.loads(json.dumps(res))
    for arm in (saved["windowed"], saved["exact"]):     # both by default
        assert len(arm["curve"]) == 1 and 0.0 <= arm["best_miou"] <= 1.0
        assert arm["final_miou"] == arm["curve"][0]["miou"]
        assert np.isfinite(arm["curve"][0]["last_train_loss"])
    assert saved["delta_best_miou"] == (saved["windowed"]["best_miou"]
                                        - saved["exact"]["best_miou"])
    assert saved["config"]["train_rooms"] == 1 and "card" not in saved


def test_build_cfg_semantic3d_differs_from_jax_only_in_ignore_label():
    """``--config semantic3d`` builds the JAX CLI's config but for the
    ignore label, which the port sets to 0 (ROADMAP.md §3)."""
    argv = ["--config", "semantic3d", "--epochs", "2"]
    got = cli.build_cfg(cli.parse_args(argv))
    want = jcli.build_cfg(jcli.parse_args(argv))
    assert got.model == want.model == "pointnet_semantic3d"
    assert got.data.ignore_label == 0 and want.data.ignore_label is None
    got = dataclasses.replace(
        got, data=dataclasses.replace(got.data, ignore_label=None))
    for name, value in _fields(got).items():
        if dataclasses.is_dataclass(value):
            assert _fields(value) == _fields(getattr(want, name)), name
        else:
            assert value == getattr(want, name), name


def test_semantic3d_labels_ignore_unlabeled_and_keep_cars():
    """Semantic3D labels 0 unlabeled and 1..8 its 8 classes.  Under the JAX
    preset (8 classes, no ignore label) the loss counts label 0 as class 0
    and drops label 8 (cars); under the port's (ignore label 0) it drops
    label 0 and counts label 8 as class 7."""
    labels = np.arange(9, dtype=np.int32).repeat(3)
    mask = np.ones(len(labels), bool)
    logits = np.random.RandomState(0).randn(len(labels), 8).astype(
        np.float32)
    jd = jsemantic3d_config().data
    assert jd.num_classes == 8 and jd.ignore_label is None
    _, jw, jlab, jvalid = jseg_loss_terms(logits, labels, mask, None,
                                          jd.ignore_label)
    jvalid = np.asarray(jvalid)
    assert jvalid[labels == 0].all() and not jvalid[labels == 8].any()
    assert float(jw) == 24.0

    td = semantic3d_config().data
    assert td.num_classes == 8 and td.ignore_label == 0
    _, tw, tlab, tvalid = seg_loss_terms(
        torch.from_numpy(logits), torch.from_numpy(labels),
        torch.from_numpy(mask), None, td.ignore_label)
    tvalid = tvalid.numpy()
    assert not tvalid[labels == 0].any() and tvalid[labels == 8].all()
    assert float(tw) == 24.0
    np.testing.assert_array_equal(tlab.numpy()[tvalid],
                                  labels[tvalid] - 1)
    assert tlab.numpy()[labels == 8].tolist() == [7, 7, 7]


def _scan(seed):
    """A small Semantic3D-like scan over 22 x 18 m: x y z intensity r g b
    and labels 0..8."""
    rng = np.random.RandomState(seed)
    n = 6000
    pts = np.concatenate([
        rng.uniform(0, 22, (n, 1)), rng.uniform(0, 18, (n, 1)),
        rng.uniform(0, 3, (n, 1)), rng.uniform(-2000, 2000, (n, 1)),
        rng.randint(0, 256, (n, 3))], 1).astype(np.float32)
    return pts, rng.randint(0, 9, n).astype(np.int32)


def test_cli_semantic3d_trains_from_block_pkls(tmp_path):
    """``--config semantic3d --data-dir`` on Semantic3D block pkls (13
    features: rgb, intensity, covariances) trains ``tiny_s3dis`` one epoch
    on the CPU and writes the JAX CLI's record with 8 classes."""
    pts, labels = _scan(0)
    blocks = semantic3d.sample_training_blocks(
        pts, labels, ds_stride=0.3, min_pn=256, covar_nn_size=1.0,
        rng=np.random.RandomState(0))
    assert len(blocks) >= 4
    semantic3d.save_blocks(str(tmp_path / "train" / "scan0.pkl"),
                           blocks[:4])
    argv = ["--config", "semantic3d", "--model", "tiny_s3dis",
            "--num-points", "512", "--batch-size", "2", "--epochs", "1",
            "--data-dir", str(tmp_path / "train"), "--device", "cpu",
            "--metrics-file", str(tmp_path / "m.jsonl")]
    state = cli.main(argv)
    assert state.step == 2   # 4 blocks, 2 a step
    rec, = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    assert set(rec) == JAX_RECORD_KEYS
    assert rec["epoch"] == 0 and np.isfinite(rec["train_loss"])
    assert 0.0 <= rec["miou"] <= 1.0 and len(rec["iou"]) == 8
    batch = next(iter(cli.make_batches(cli.build_cfg(cli.parse_args(argv)),
                                       cli.parse_args(argv), "train",
                                       2)(0)))
    assert batch["feats"].shape == (2, 512, 13)


def test_cli_semantic3d_synthetic_batches_match_jax():
    """``--config semantic3d --synthetic`` gives the JAX CLI's batches: 13
    feature columns, labels of the 8 classes."""
    argv = ["--config", "semantic3d", "--synthetic", "--num-points", "256",
            "--steps-per-epoch", "2"]
    args = cli.parse_args(argv)
    jargs = jcli.parse_args(argv)
    got = list(cli.make_batches(cli.build_cfg(args), args, "train", 2)(0))
    want = list(jcli.make_batches(jcli.build_cfg(jargs), jargs, "train",
                                  2)())
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["feats"].shape == (2, 256, 13)
        assert g["labels"].max() < 8
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
