"""The port's user entry points on the CPU: the train CLI against the JAX
CLI's config and LR, a ``tiny_s3dis`` run that checkpoints and writes the
JAX CLI's metrics record, ``--restore --eval`` reproducing the epoch's test
metrics, training from prepared room pkls, the feature ablations against
the JAX CLI's, the scene eval on synthetic blocks and on a prepared room
(with the 12-feature checkpoint), and one epoch of the training-curve
run."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from pointcloudsegmentation_tpu.train import cli as jcli
from pointcloudsegmentation_tpu.train.loop import Trainer as JTrainer
from pointcloudsegmentation_tpu_torch import interpolate, parity_ab
from pointcloudsegmentation_tpu_torch.data import s3dis, synth_rooms
from pointcloudsegmentation_tpu_torch.train import cli

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
    arm = saved["windowed"]
    assert len(arm["curve"]) == 1 and 0.0 <= arm["best_miou"] <= 1.0
    assert arm["final_miou"] == arm["curve"][0]["miou"]
    assert np.isfinite(arm["curve"][0]["last_train_loss"])
    assert saved["config"]["train_rooms"] == 1 and "card" not in saved
