"""The port's A/B arms (``pointcloudsegmentation_tpu_torch.ab_arms``)
against ``scripts/ab_arms.py``: an arm's config is the ``TrainConfig`` the
JAX ``run_arm`` builds, its ``env`` gives the port's encoder the fields
the JAX ``build_model`` reads from the environment (the JAX errors raise on
both sides), the switches the port has no counterpart of raise, its
batches are the JAX ``toy_batches`` arrays, and a CPU run of the arms
prints the JAX keys, builds a fresh ``Trainer`` per arm, prints a failing
arm's error line, runs the next arm and exits 1, and leaves
``os.environ`` as it was."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from pointcloudsegmentation_tpu.data import toy as jtoy
from pointcloudsegmentation_tpu.train import config as jconfig
from pointcloudsegmentation_tpu.train.model_zoo import build_model as jbuild
from pointcloudsegmentation_tpu_torch import ab_arms
from pointcloudsegmentation_tpu_torch.train.model_zoo import build_model

torch.set_num_threads(1)
JAX_PRESETS = {"s3dis": jconfig.s3dis_config,
               "scannet": jconfig.scannet_config,
               "semantic3d": jconfig.semantic3d_config}
# the JAX keys of a result line, in order (scripts/ab_arms.py:78-81)
KEYS = ["label", "points_per_sec", "step_ms", "batch", "model", "points",
        "chains_ms"]


def _jax_config(arm):
    """The config ``scripts/ab_arms.py:run_arm`` builds (its :51-56)."""
    overrides = {}
    if "points" in arm:
        overrides["data_num_points"] = int(arm["points"])
    if "model" in arm:
        overrides["model"] = arm["model"]
    return JAX_PRESETS[arm.get("config", "s3dis")](**overrides)


@pytest.mark.parametrize("arm", [
    {"label": "base"}, {"label": "p", "points": 4096},
    {"label": "sn", "config": "scannet"},
    {"label": "s3d", "config": "semantic3d"},
    {"label": "ecd", "model": "ecd_s3dis"}], ids=lambda a: a["label"])
def test_arm_config_is_the_jax_scripts(arm):
    want = dataclasses.asdict(_jax_config(arm))
    got = dataclasses.asdict(ab_arms.arm_config(arm))
    if arm.get("config") == "semantic3d":
        # the port ignores Semantic3D's unlabeled 0 on purpose (R5)
        assert want["data"].pop("ignore_label") is None
        assert got["data"].pop("ignore_label") == 0
    assert got == want


# (env name, values): every accepted name, with values the JAX build
# refuses among them
ENV_CASES = [
    ("PCS_WIN_WINDOW", ["256", "512", "1024", "128", "64", "0", "-256",
                        "100", "x"]),
    ("PCS_OV_POOL", ["0", "256", "384", "-1", "x"]),
    ("PCS_CAND_K", ["0", "24", "48", "x"]),
    ("PCS_REMAT", ["1", "0", "true", ""]),
    ("PCS_SEL_MODE", ["", "global", "slab", "salb"]),
    ("PCS_DISABLE_WINDOWED", ["1", "0", ""]),
]
FIELDS = ("win_window", "win_tile", "ov_pool_size", "win_cand_k", "remat",
          "sel_mode")


@pytest.mark.parametrize("name,value", [(n, v) for n, vs in ENV_CASES
                                        for v in vs])
def test_env_gives_the_jax_encoder_fields(name, value, monkeypatch):
    """Under ``monkeypatch.setenv`` the JAX ``build_model`` gives its
    encoder's fields (or raises); ``encoder_settings`` of the same
    ``env`` gives the port's encoder the same fields (or raises the
    same), with the environment unset on the port's side."""
    cfg = ab_arms.arm_config({"label": "x"})
    for k in [k for k in os.environ if k.startswith("PCS_")]:
        monkeypatch.delenv(k)
    monkeypatch.setenv(name, value)
    try:
        jenc = jbuild(_jax_config({"label": "x"})).encoder
    except ValueError:
        jenc = None
    monkeypatch.delenv(name)
    if jenc is None:
        with pytest.raises(ValueError):
            ab_arms.encoder_settings({name: value})
        return
    settings = ab_arms.encoder_settings({name: value})
    enc = build_model(cfg, None, "cpu", **settings).encoder
    for f in FIELDS:
        assert getattr(enc, f) == getattr(jenc, f), f
    assert enc.windowed == (not (name == "PCS_DISABLE_WINDOWED"
                                 and value == "1"))


@pytest.mark.parametrize("name", sorted(ab_arms.NO_COUNTERPART)
                         + ["PCS_NO_SUCH_SWITCH"])
def test_switches_without_a_counterpart_raise(name):
    with pytest.raises(ValueError, match=name):
        ab_arms.encoder_settings({name: "1"})


def test_env_values_are_read_as_strings():
    assert ab_arms.encoder_settings({"PCS_REMAT": 1, "PCS_CAND_K": 24,
                                     "PCS_DISABLE_WINDOWED": 1}) == \
        {"remat": True, "win_cand_k": 24, "windowed": False}


@pytest.mark.parametrize("config", ["s3dis", "scannet"])
def test_arm_batches_are_the_jax_batches(config):
    cfg = ab_arms.arm_config({"label": "x", "config": config,
                              "points": 700})
    got = ab_arms.arm_batches(cfg, 3)
    want = list(jtoy.toy_batches(
        2, batch_size=3, num_points=700, kind="room",
        num_classes=cfg.data.num_classes, feat_dim=cfg.data.feat_dim))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


def test_cpu_run_of_the_arms(monkeypatch, capsys):
    """Two ``tiny_s3dis`` arms (512 points, batch 2, 1 step a chain)
    around one the port refuses.  The environment holds switches that
    would change the arms if the port read them."""
    monkeypatch.setenv("PCS_DISABLE_WINDOWED", "1")
    monkeypatch.setenv("PCS_REMAT", "1")
    before = dict(os.environ)
    built = []

    class Recorded(ab_arms.Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            built.append(self)

    monkeypatch.setattr(ab_arms, "Trainer", Recorded)
    tiny = {"model": "tiny_s3dis", "points": 512, "batch": 2, "iters": 1}
    arms = [dict(tiny, label="a"),
            dict(tiny, label="vmap", env={"PCS_BATCH_VMAP": "1"}),
            dict(tiny, label="b", chunk=256, env={"PCS_CAND_K": "24"})]
    assert ab_arms.main([json.dumps(arms), "--device", "cpu"]) == 1
    assert dict(os.environ) == before
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["label"] for x in lines] == ["a", "vmap", "b"]
    for x in (lines[0], lines[2]):
        assert list(x) == KEYS
        assert (x["batch"], x["model"], x["points"]) == (2, "tiny_s3dis",
                                                         512)
        assert len(x["chains_ms"]) == ab_arms.CHAINS
        assert x["chains_ms"] == sorted(x["chains_ms"])
        assert x["step_ms"] == x["chains_ms"][1] and x["points_per_sec"] > 0
    assert list(lines[1]) == ["label", "error"]
    assert "PCS_BATCH_VMAP" in lines[1]["error"]
    assert len(built) == 2 and built[0] is not built[1]
    encs = [t.model.encoder for t in built]
    assert all(e.windowed and not e.remat for e in encs)
    assert encs[0].win_cand_k != 24 and encs[1].win_cand_k == 24
    assert built[1]._encoder_kw["search_chunk"] == 256


def test_main_refuses_without_a_card_before_any_arm(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    ran = []
    monkeypatch.setattr(ab_arms, "run_arm", lambda *a: ran.append(a))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ab_arms.main(['[{"label": "base"}]'])
    assert not ran
