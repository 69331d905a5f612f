"""The port's user tools against the JAX package's scripts (imported from
``scripts/`` through ``sys.path``): the curve comparison's summary, the
search-recall numbers at 1024 points, both eval-parity arms on one
synthetic test room at 1024 points with the same weights, and the
conv-compare harness's flavors and records; plus the tools' CPU runs
(profile and trace of the flagship's step)."""
import json
import math
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))

import analysis_compare as janalysis_compare  # noqa: E402
import conv_compare as jconv_compare  # noqa: E402
import verify_search_recall as jrecall  # noqa: E402

from pointcloudsegmentation_tpu.data import batching as jbatching  # noqa: E402
from pointcloudsegmentation_tpu.data import native as jnative  # noqa: E402
from pointcloudsegmentation_tpu.eval import (  # noqa: E402
    eval_scene_probs as jeval_scene_probs,
    interpolate_to_dense as jinterpolate_to_dense, scene_iou as jscene_iou)
from pointcloudsegmentation_tpu.train.config import \
    s3dis_config as js3dis  # noqa: E402
from pointcloudsegmentation_tpu.train.model_zoo import \
    build_model as jbuild  # noqa: E402
from pointcloudsegmentation_tpu_torch import (  # noqa: E402
    analysis_compare, conv_compare, eval_parity, profile_step, profile_train,
    trace_step, verify_search_recall)
from pointcloudsegmentation_tpu_torch.config import \
    s3dis_config as ts3dis  # noqa: E402
from pointcloudsegmentation_tpu_torch.convert import \
    load_flax_params  # noqa: E402
from pointcloudsegmentation_tpu_torch.train import cli  # noqa: E402
from pointcloudsegmentation_tpu_torch.train.model_zoo import \
    build_model as tbuild  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
ARGMAX_MIN = 0.999
MIOU_TOL = 1e-3


# -- analysis_compare

def _write_jsonl(path, epochs=5, c=13):
    with open(path, "w") as f:
        for e in range(epochs):
            f.write(json.dumps({
                "epoch": e, "train_loss": 2.0 - 0.1 * e,
                "lr": 1e-3 * 0.9 ** e,
                "miou": 0.1 + 0.05 * ((e * 3) % 5), "oiou": 0.2 + 0.05 * e,
                "oacc": 0.5 + 0.03 * e,
                "iou": [0.1 * ((e + i) % 5) for i in range(c)],
                "acc": [0.5] * c}) + "\n")
        # an --eval record and a re-run epoch: dropped / kept last
        f.write(json.dumps({"epoch": -1, "split": "eval", "miou": 0.9}) + "\n")
        f.write(json.dumps({"epoch": 2, "miou": 0.33, "oacc": 0.6}) + "\n")


def _write_log(path, epochs=5):
    with open(path, "w") as f:
        for e in range(epochs):
            f.write(f"ts INFO epoch {e} train-loss {2.0 - 0.09 * e:.4f} | "
                    f"test mIoU {0.1 + 0.04 * e:.4f} oIoU "
                    f"{0.2 + 0.04 * e:.4f} oAcc {0.5 + 0.02 * e:.4f} | "
                    "100000 points/s\n")


@pytest.mark.parametrize("metric,figures", [
    ("miou", ["--per-class", "--class-names", "s3dis"]),
    ("train_loss", [])])
def test_analysis_compare_summary_matches_jax(metric, figures, tmp_path):
    j, log = tmp_path / "a.metrics.jsonl", tmp_path / "b.log"
    _write_jsonl(j)
    _write_log(log)
    common = [str(j), str(log), "--labels", "A", "B", "--metric",
              metric] + figures
    want = janalysis_compare.main(common + ["--out-dir",
                                            str(tmp_path / "jax")])
    got = analysis_compare.main(common + ["--out-dir", str(tmp_path / "t")])
    assert got == want
    names = [f"compare_{metric}.png", "summary.json"] + (
        ["per_class_A.png"] if figures else [])
    for name in names:
        assert (tmp_path / "t" / name).exists(), name
    assert json.loads((tmp_path / "t" / "summary.json").read_text()) == \
        json.loads((tmp_path / "jax" / "summary.json").read_text())


def test_analysis_compare_reads_the_port_cli_metrics(tmp_path):
    ck = tmp_path / "ck"
    cli.main(["--config", "s3dis", "--synthetic", "--model", "tiny_s3dis",
              "--num-points", "256", "--batch-size", "1",
              "--steps-per-epoch", "1", "--epochs", "1", "--device", "cpu",
              "--checkpoint-dir", str(ck)])
    recs = analysis_compare.load_run(str(ck))     # the run directory
    assert [r["epoch"] for r in recs] == [0]
    assert recs == janalysis_compare.load_run(str(ck / "metrics.jsonl"))
    summary = analysis_compare.main([str(ck), "--labels", "run", "--curves",
                                     "--out-dir", str(tmp_path / "out")])
    assert summary["run"]["epochs"] == 1
    assert 0.0 <= summary["run"]["best"] <= 1.0
    assert (tmp_path / "out" / "curves_run.png").exists()


# -- verify_search_recall

def _loop_recall(xyz, found):
    """``scripts/verify_search_recall.py``'s per-point loop."""
    d2 = ((xyz[:, None, :].astype(np.float64)
           - xyz[None, :, :].astype(np.float64)) ** 2).sum(-1)
    out = []
    for (mn, mx, k), (ai, am) in zip(verify_search_recall.BANDS, found):
        band = (d2 <= mx * mx) & (d2 >= mn * mn)
        if mn > 0:
            np.fill_diagonal(band, False)
        inter = total = 0
        for i in range(len(xyz)):
            cand = np.where(band[i])[0]
            want = set(cand[np.argsort(d2[i][cand], kind="stable")][:k])
            inter += len(set(ai[i][am[i]]) & want)
            total += len(want)
        out.append(((mn, mx, k), inter / max(total, 1)))
    return out


def test_exact_recall_equals_the_loop_on_ties_and_repeats():
    """The whole-array reference counts what the script's loop counts:
    a duplicated point (equal distances, ties to the lower index), a slot
    repeated in one row, a narrow pool that misses neighbors."""
    xyz = verify_search_recall.room_cloud(512, 3)
    xyz[5] = xyz[7]
    rng = np.random.RandomState(0)
    found = []
    for _, _, k in verify_search_recall.BANDS:
        idx = rng.randint(0, 512, (512, k)).astype(np.int32)
        mask = rng.rand(512, k) < 0.7
        idx[0, 1] = idx[0, 0]
        mask[0, :2] = True
        found.append((idx, mask))
    got = verify_search_recall.exact_recall(xyz, found)
    assert got == _loop_recall(xyz, found)


def test_band_recall_equals_jax():
    got = verify_search_recall.band_recall(n=1024, seed=0, device="cpu")
    want = jrecall.band_recall(n=1024, seed=0)
    assert got == want
    assert all(r >= verify_search_recall.GLOBAL_MIN for _, r in got)


def test_production_windowed_recall_equals_jax():
    sel_mode, ck, pool, window = verify_search_recall.PRODUCTION
    kw = dict(n=1024, cand_k=ck, seed=0, sel_mode=sel_mode,
              ov_pool_size=pool, window=window)
    got = verify_search_recall.windowed_band_recall(device="cpu", **kw)
    want = jrecall.windowed_band_recall(**kw)
    assert got == want
    assert all(r >= verify_search_recall.WINDOWED_MIN for _, r in got)


# ids as they were when the tool also refused global selection
@pytest.mark.parametrize("argv,match", [
    pytest.param(["--grid", "slab:32:256"], "cannot be combined",
                 id="argv3-cannot be combined"),
    pytest.param(["slab:32"], "bad config", id="argv4-bad config"),
    pytest.param(["edges:32:256"], "bad sel_mode", id="argv5-bad sel_mode"),
])
def test_search_recall_refuses_what_the_port_lacks(argv, match):
    with pytest.raises(SystemExit, match=match):
        verify_search_recall.main(argv + ["--device", "cpu"])


# -- eval_parity

NP, CAPS = 1024, (1024, 256)
ROOM_BLOCKS = 2


@pytest.fixture(scope="module")
def parity():
    """One synthetic test room (RandomState(10_000)) cut to its first
    ``ROOM_BLOCKS`` blocks (a sweep of the whole room's 8 blocks costs the
    CPU ~7 s an arm), and random flax weights for the flagship at 1024
    points."""
    jnative.ensure_built()
    rooms = [eval_parity.held_out_rooms(1)[0][:ROOM_BLOCKS]]
    jm = jbuild(js3dis(data_num_points=NP, data_caps=CAPS),
                search_chunk=2048)
    b = rooms[0][0]
    pb = jbatching.pad_block(b["xyz"], b["feats"], b["labels"], NP)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), pb["xyz"], pb["feats"], pb["mask"], False))
    rng = np.random.RandomState(4)

    def draw(path, s):
        if path[-1].key == "kernel":
            lim = np.sqrt(6.0 / (s.shape[0] + s.shape[1]))
            return rng.uniform(-lim, lim, s.shape).astype(np.float32)
        return rng.uniform(-0.1, 0.1, s.shape).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    return dict(rooms=rooms, params=params)


def jax_arm(rooms, params, exact):
    """The JAX script's per-arm loop (``scripts/eval_parity.py:99-123``) on
    ``params``, each room subsampled as ``eval_arm`` subsamples it (the
    script's own draw is unseeded): the dense argmax and mIoU of each
    room."""
    with pytest.MonkeyPatch.context() as mp:
        if exact:
            mp.setenv("PCS_DISABLE_WINDOWED", "1")
        jm = jbuild(js3dis(data_num_points=NP, data_caps=CAPS),
                    search_chunk=2048)
        apply_fn = jax.jit(lambda p_, x, f, m_: jm.apply(p_, x, f, m_,
                                                         False))
        preds, mious = [], []
        for si, room in enumerate(rooms):
            rng = np.random.RandomState(si)   # eval_arm's subsample
            blocks = []
            for b in room:
                pb = jbatching.pad_block(b["xyz"], b["feats"], b["labels"],
                                         NP, rng=rng)
                pb["block_min"] = b["block_min"]
                blocks.append(pb)
            dense_xyz = np.concatenate(
                [b["xyz"][b["mask"]] + b["block_min"] for b in blocks], 0)
            dense_labels = np.concatenate(
                [b["labels"][b["mask"]] for b in blocks], 0)
            sxyz, probs = jeval_scene_probs(apply_fn, params, blocks)
            q = jinterpolate_to_dense(sxyz, probs, dense_xyz, k=6)
            preds.append(q.argmax(1))
            mious.append(float(jscene_iou(dense_labels, preds[-1],
                                          13)["miou"]))
    return preds, mious


def port_arm_model(params, windowed):
    model = tbuild(ts3dis(compute_dtype="float32", data_num_points=NP,
                          data_caps=CAPS), device="cpu", windowed=windowed,
                   search_chunk=2048)
    return load_flax_params(model, params).eval()


@pytest.mark.parametrize("arm", ["windowed", "exact"])
def test_eval_arm_matches_the_jax_pipeline(arm, parity):
    want_preds, want_mious = jax_arm(parity["rooms"], parity["params"],
                                     exact=arm == "exact")
    rec, preds = eval_parity.eval_arm(
        port_arm_model(parity["params"], arm == "windowed"),
        parity["rooms"], NP, 13, "cpu")
    assert set(rec) == {"miou_per_scene", "miou", "eval_points_per_sec"}
    for got, want in zip(preds, want_preds):
        assert got.shape == want.shape
        assert (got == want).mean() >= ARGMAX_MIN
    assert np.allclose(rec["miou_per_scene"], want_mious, atol=MIOU_TOL,
                       rtol=0)
    assert 0.0 <= rec["miou"] <= 1.0 and rec["eval_points_per_sec"] > 0


def test_eval_arm_refuses_a_model_on_another_device(parity):
    with pytest.raises(ValueError, match="lives on cpu"):
        eval_parity.eval_arm(port_arm_model(parity["params"], True),
                             parity["rooms"], NP, 13, "cuda")


def test_eval_parity_writes_the_jax_keys(parity, tmp_path, monkeypatch):
    """``main`` without training (0 rooms, 0 epochs) on 2 blocks of the
    fixture's room, float32 at 512 points with caps (512, 128) so the CPU
    run is short: the file has the JAX record's keys, arm by arm."""
    monkeypatch.setattr(eval_parity, "held_out_rooms",
                        lambda count: [parity["rooms"][0][:2]])
    monkeypatch.setattr(eval_parity, "s3dis_config", lambda **kw: ts3dis(
        compute_dtype="float32", data_caps=(512, 128), **kw))
    out = tmp_path / "eval_parity_torch.json"
    res = eval_parity.main(["--train-rooms", "0", "--test-rooms", "1",
                            "--epochs", "0", "--num-points", "512",
                            "--device", "cpu", "--out", str(out)])
    want = json.loads((ROOT / "results" / "eval_parity.json").read_text())
    got = json.loads(out.read_text())
    assert got == json.loads(json.dumps(res))
    assert set(got) == set(want)
    assert set(got["config"]) == set(want["config"]) | {"device"}
    for arm in ("windowed", "exact"):
        assert set(got[arm]) == set(want[arm])
        assert 0.0 <= got[arm]["miou"] <= 1.0
    assert got["delta_miou"] == pytest.approx(got["windowed"]["miou"]
                                              - got["exact"]["miou"])
    assert got["speedup"] > 0


# -- conv_compare

def test_flavors_equal_jax():
    assert conv_compare.FLAVORS == jconv_compare.FLAVORS


@pytest.mark.parametrize("flavor", ["pointnet_s3dis", "ecd_s3dis"])
def test_run_flavor_records(flavor):
    args = SimpleNamespace(epochs=1, steps=2, batch=2, num_points=512)
    log = conv_compare.get_logger("pcs_torch.conv_compare")
    recs = conv_compare.run_flavor(flavor, args, log, device="cpu")
    assert len(recs) == 1
    assert set(recs[0]) == {"epoch", "loss", "miou", "oacc", "epoch_sec"}
    assert all(math.isfinite(v) for v in recs[0].values())
    assert 0.0 <= recs[0]["miou"] <= 1.0 and 0.0 <= recs[0]["oacc"] <= 1.0


# -- profile_step, trace_step, profile_train

def test_profile_step_and_trace_on_the_cpu(tmp_path, capsys):
    rows = profile_step.main(["--num-points", "256", "--batch", "1",
                              "--warmup", "0", "--iters", "1",
                              "--logdir", str(tmp_path), "--device", "cpu"])
    assert list(rows) == ["full train step", "step w/ host batch",
                          "pyramid", "encoder fwd (1 block)"]
    for row in rows.values():
        assert set(row) == {"ms_median", "ms_min", "ms_max", "ms_mean"}
        assert row["ms_min"] > 0
    res = trace_step.main(["--analyze-only", "--logdir", str(tmp_path),
                           "--top", "3"])
    assert res["what"] == "cpu_op" and res["total_ms"] > 0
    assert len(capsys.readouterr().out.split("aten::")) >= 4


def test_profile_train_summarize_sums_by_name():
    cuda = torch.autograd.DeviceType.CUDA
    cpu = torch.autograd.DeviceType.CPU

    def row(key, device, count, us):
        return SimpleNamespace(key=key, device_type=device, count=count,
                               self_device_time_total=us,
                               self_cpu_time_total=us)

    s = profile_train.summarize(
        [row("gemm", cuda, 6, 600.0), row("gather", cuda, 3, 1800.0),
         row("Memcpy HtoD", cuda, 3, 300.0), row("cudaLaunchKernel", cpu,
                                                 9, 90.0),
         row("aten::mm", cpu, 6, 50.0)], steps=3, step_s=0.002)
    assert [r[0] for r in s["kernels"]] == ["gather", "gemm"]
    assert [r[1:] for r in s["kernels"]] == [
        pytest.approx((1.0, 0.6, 0.75)), pytest.approx((2.0, 0.2, 0.25))]
    assert s["kernel_ms"] == pytest.approx(0.8)
    assert s["kernel_launches"] == 3.0
    assert s["copy_ms"] == pytest.approx(0.1) and s["copies"] == 1.0
    assert s["busy"] == pytest.approx(0.45)
    (key, n, ms), = s["runtime"]
    assert key == "cudaLaunchKernel" and (n, ms) == pytest.approx((3.0, 0.03))
