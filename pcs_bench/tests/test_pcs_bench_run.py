"""A whole run of a tiny cell on the CPU (the harness's look for a card
skipped): the result line, the modules loaded, and ``correct`` coming out
false when the timed path is broken underneath."""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from pcs_bench import harness
from pointcloudsegmentation_tpu_torch.eval import interpolate
from pointcloudsegmentation_tpu_torch.train.loop import Trainer

from conftest import ROOT, tiny_cell

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device",
               "checks"]


def _run(cell, seed=2 ** 31 + 11):
    return harness.run_cell(cell, seed, 0.2, False, "cpu",
                            time.perf_counter(), log=lambda s: None)


@pytest.mark.parametrize("workload", ["pointnet_s3dis.train_dense",
                                      "pointnet_s3dis.label_dense"])
def test_result_line(bench, workload, capsys):
    """The last line of standard output is the result, its keys in order
    and the compared numbers last; a float32 run of the program agrees
    with the reference and is correct."""
    res = _run(tiny_cell(bench, workload, "float32"))
    harness.report(res)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == RESULT_KEYS
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    cell = harness.Cell(bench, workload)
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    for name, c in line["checks"].items():
        assert f"{name} {c['value']} limit {c['limit']}" in err
    assert err.strip().splitlines()[-1].startswith(list(line["checks"])[-1])


def test_nothing_of_jax_is_loaded(tmp_path):
    """After a run, no module whose top-level name is jax, jaxlib, flax or
    the JAX package is loaded (compared as whole names: the port's name
    begins with the JAX package's)."""
    probe = (
        "import sys, time, torch\n"
        "torch.set_num_threads(1)\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"sys.path.insert(0, {os.path.dirname(__file__)!r})\n"
        "from pcs_bench import harness\n"
        "from conftest import tiny_cell\n"
        "b = harness.load_json(harness.ROOT + '/BENCHMARK.json')\n"
        "harness.run_cell(tiny_cell(b, 'ecd_s3dis.label_dense', 'float32'),"
        " 3, 0.1, False, 'cpu', time.perf_counter(), log=lambda s: None)\n"
        "print(harness.forbidden_modules())\n"
        "print(sorted(m for m in sys.modules\n"
        "      if m.split('.')[0] == 'pointcloudsegmentation_tpu_torch')[:1])\n")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=600, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    forbidden, port = out.stdout.strip().splitlines()[-2:]
    assert forbidden == "[]"
    assert port != "[]"


def test_a_step_that_returns_its_state_unchanged_is_not_correct(
        bench, monkeypatch):
    real = Trainer.train_step

    def stuck(self, state, batch):
        return state, real(self, state, batch)[1]

    monkeypatch.setattr(Trainer, "train_step", stuck)
    res = _run(tiny_cell(bench, "pointnet_s3dis.train_dense", "float32"))
    assert res["correct"] is False
    assert res["checks"]["grad_gap"]["value"] >= 0.99


def test_half_of_the_batch_left_out_is_not_correct(bench, monkeypatch):
    real = Trainer.train_step

    def half(self, state, batch):
        return real(self, state, {k: v[:v.shape[0] // 2]
                                  for k, v in batch.items()})

    monkeypatch.setattr(Trainer, "train_step", half)
    res = _run(tiny_cell(bench, "ecd_s3dis.train_dense", "float32"))
    assert res["correct"] is False


def test_an_answer_altered_where_it_is_produced_is_not_correct(
        bench, monkeypatch):
    real = interpolate.eval_scene_probs
    from pcs_bench.drivers import scene_probs

    def altered(model, blocks, *a, **kw):
        xyz, probs = real(model, blocks, *a, **kw)
        probs = probs.copy()
        k = int(np.argmin(probs[17]))
        probs[17] = 0.0
        probs[17, k] = 1.0
        return xyz, probs

    monkeypatch.setattr(scene_probs, "eval_scene_probs", altered)
    res = _run(tiny_cell(bench, "pointnet_s3dis.label_dense", "float32"))
    assert res["correct"] is False
    assert res["checks"]["argmax_gap_max"]["value"] > 10.0


@pytest.mark.card
@pytest.mark.parametrize("workload", ["pointnet_s3dis.train_dense",
                                      "pointnet_s3dis.label_dense"])
def test_a_cell_on_the_card_is_correct(bench, card, workload):
    """The cell at its own size on the card, with a short window."""
    res = harness.run_cell(harness.Cell(bench, workload), 2 ** 31 + 21, 2.0,
                           False, card, time.perf_counter(),
                           log=lambda s: None)
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"
