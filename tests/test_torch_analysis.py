"""The port's analysis layer against the JAX package's: the viz dumps and
color tables, the profiling helpers, activation capture layer by layer
(``tiny_s3dis`` at 512 points, float32, converted weights, against one
jitted flax ``capture_intermediates`` program), the k-means and cluster
dumps bit for bit, and R11: the JAX ``capture_activations`` cannot
capture a segmentation model, whose encoder returns a tuple."""
import re
from collections.abc import Mapping

import jax
import numpy as np
import pytest
import torch

from pointcloudsegmentation_tpu.data import toy
from pointcloudsegmentation_tpu.eval import analysis as janalysis
from pointcloudsegmentation_tpu.models.layers import \
    GrowthMLP as JGrowthMLP
from pointcloudsegmentation_tpu.train.config import s3dis_config as js3dis
from pointcloudsegmentation_tpu.train.model_zoo import build_model as jbuild
from pointcloudsegmentation_tpu.utils import profiling as jprofiling
from pointcloudsegmentation_tpu.utils import viz as jviz
from pointcloudsegmentation_tpu_torch import trace_step
from pointcloudsegmentation_tpu_torch.config import s3dis_config as ts3dis
from pointcloudsegmentation_tpu_torch.convert import load_flax_params
from pointcloudsegmentation_tpu_torch.eval import analysis as tanalysis
from pointcloudsegmentation_tpu_torch.models.layers import \
    GrowthMLP as TGrowthMLP
from pointcloudsegmentation_tpu_torch.train.model_zoo import \
    build_model as tbuild
from pointcloudsegmentation_tpu_torch.utils import profiling as tprofiling
from pointcloudsegmentation_tpu_torch.utils import viz as tviz

torch.set_num_threads(1)
N, CAPS = 512, (512, 128)
REL = 1e-4          # of max(1, the largest |JAX value|)
# JAX keys the port has no module for, each with its reason
UNPORTED = {
    # the port's SegClassifier applies dropout as a function
    # (torch.nn.functional.dropout), not as a submodule
    "head/Dropout_0/__call__": "functional dropout",
    "head/Dropout_1/__call__": "functional dropout",
}


MODULE_LEVEL = re.compile(r"^([^/]+/)?([^/]+/)?__call__(/\d+)?$")


def flatten(node, prefix=""):
    """flax intermediates -> {path: float32 array}, the first call's value;
    a tuple value is split into ``<path>/<i>`` (what the JAX walk cannot
    do: R11)."""
    if isinstance(node, Mapping):
        out = {}
        for k, v in node.items():
            out.update(flatten(v, f"{prefix}/{k}" if prefix else k))
        return out
    v = node[0]
    if isinstance(v, tuple):
        return {f"{prefix}/{i}": np.asarray(x, np.float32)
                for i, x in enumerate(v)}
    return {prefix: np.asarray(v, np.float32)}


@pytest.fixture(scope="module")
def tiny():
    """``tiny_s3dis`` at 512 points (tile = window = 64, so levels 0 and 1
    take the windowed search) with random weights: the JAX model's
    intermediates from one jitted program, and the port's model with the
    same weights."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PCS_WIN_WINDOW", "64")
        jm = jbuild(js3dis(model="tiny_s3dis", data_num_points=N,
                           data_caps=CAPS), search_chunk=N)
        rng = np.random.RandomState(0)
        b = toy.synthetic_room_block(rng, n=N)
        mask = np.ones(N, bool)
        mask[rng.choice(N, 24, replace=False)] = False
        xyz = b["xyz"].copy()
        xyz[~mask] = 0.0
        args = (xyz, b["feats"], mask)
        shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                                *args, False))
        wrng = np.random.RandomState(1)
        params = jax.tree_util.tree_map(
            lambda s: wrng.uniform(-0.5, 0.5, s.shape).astype(np.float32),
            shapes)
        applied = jax.jit(lambda p: jm.apply(
            p, *args, False, capture_intermediates=True,
            mutable=["intermediates"]))(params)
    tm = tbuild(ts3dis(model="tiny_s3dis", compute_dtype="float32",
                       data_caps=CAPS), device="cpu", win_tile=64,
                win_window=64, search_chunk=N)
    load_flax_params(tm, params)
    return dict(jm=jm, params=params, args=args, applied=applied,
                want=flatten(applied[1]["intermediates"]), tm=tm)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def captured(tiny):
    out, acts = tanalysis.capture_activations(
        tiny["tm"], *(_t(a) for a in tiny["args"]))
    return out, acts


# -- viz

@pytest.mark.parametrize("num_classes", [13, 9, 5])
def test_class_colors_match_jax(num_classes):
    np.testing.assert_array_equal(tviz.class_colors(num_classes),
                                  jviz.class_colors(num_classes))


@pytest.mark.parametrize("labels_kind", ["labels", "colors", "none"])
def test_point_dumps_match_jax_bytes(labels_kind, tmp_path):
    rng = np.random.RandomState(2)
    xyz = rng.randn(50, 3).astype(np.float32)
    labels = rng.randint(0, 13, 50)
    paths = [tmp_path / "jax.txt", tmp_path / "torch.txt"]
    for viz, path in zip((jviz, tviz), paths):
        if labels_kind == "labels":
            viz.output_labeled_points(str(path), xyz, labels, 13)
        elif labels_kind == "colors":
            viz.output_points(str(path), xyz, labels)
        else:
            viz.output_points(str(path), xyz)
    assert paths[1].read_bytes() == paths[0].read_bytes()
    assert len(paths[1].read_text().splitlines()) == 50


def test_plot_confusion_matrix_writes_png(tmp_path):
    cm = np.random.RandomState(3).randint(0, 20, (4, 4))
    path = tmp_path / "cm.png"
    assert tviz.plot_confusion_matrix(cm, list("abcd"), str(path))
    assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


# -- profiling

def test_time_fn_keys():
    x = torch.randn(64, 64)
    got = tprofiling.time_fn(lambda a: a @ a, x, warmup=1, iters=3)
    want = jprofiling.time_fn(lambda a: a @ a, np.ones((4, 4), np.float32),
                              warmup=1, iters=3)
    assert got.keys() == want.keys()
    assert all(v > 0 for v in got.values())
    assert got["ms_min"] <= got["ms_median"] <= got["ms_max"]


def test_trace_of_a_cpu_forward_is_analyzed(tiny, tmp_path, capsys):
    with tprofiling.trace(str(tmp_path), cuda=False):
        with torch.no_grad():
            tiny["tm"](*(_t(a) for a in tiny["args"]))
    assert list(tmp_path.glob("*.pt.trace.json"))
    res = trace_step.analyze(str(tmp_path), top=5, steps=1)
    assert res["what"] == "cpu_op" and res["total_ms"] > 0
    assert len(res["rows"]) >= 1
    assert abs(sum(r[3] for r in res["rows"]) - 1.0) < 1e-6
    assert "aten::" in capsys.readouterr().out


def test_cpu_self_times_subtract_direct_children():
    ev = [dict(name="outer", pid=1, tid=1, ts=0.0, dur=10.0),
          dict(name="inner", pid=1, tid=1, ts=1.0, dur=4.0),
          dict(name="leaf", pid=1, tid=1, ts=2.0, dur=1.0),
          dict(name="inner", pid=1, tid=1, ts=6.0, dur=2.0),
          dict(name="other", pid=1, tid=2, ts=3.0, dur=5.0)]
    total, rows = tprofiling.by_name(trace_step._cpu_self_times(ev))
    got = {name: (n, ms) for name, n, ms, _ in rows}
    assert got == {"outer": (1, 0.004), "inner": (2, 0.005),
                   "leaf": (1, 0.001), "other": (1, 0.005)}
    assert total == pytest.approx(0.015)


# -- activation capture

def test_capture_matches_jax_layer_by_layer(tiny, captured):
    want = tiny["want"]
    out, got = captured
    assert set(want) - set(got) == set(UNPORTED)
    assert set(got) <= set(want)
    compared = []
    for key, g in got.items():
        w = want[key]
        if g.shape != w.shape:
            continue
        assert g.dtype == np.float32
        scale = max(1.0, float(np.abs(w).max()))
        err = float(np.abs(g - w).max()) / scale
        assert err <= REL, (key, err)
        compared.append(key)
    # the model, its encoder and head, and each of their modules
    module_level = {k for k in want if MODULE_LEVEL.match(k)} - set(UNPORTED)
    assert "encoder/__call__/0" in module_level
    assert module_level <= set(compared), module_level - set(compared)
    # everything the port records has JAX's shape
    assert set(compared) == set(got)
    np.testing.assert_array_equal(out.numpy(), got["__call__"])


def test_capture_keeps_the_first_call_and_removes_hooks():
    lin = torch.nn.Linear(3, 2)
    model = torch.nn.Module()
    model.lin = lin
    model.forward = lambda x: lin(lin(x)[:, :1].repeat(1, 3))
    x = torch.randn(4, 3)
    _, acts = tanalysis.capture_activations(model, x)
    with torch.no_grad():
        np.testing.assert_array_equal(acts["lin/__call__"], lin(x).numpy())
    assert not lin._forward_hooks and not model._forward_hooks


def test_growth_mlp_keys_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(40, 5).astype(np.float32)
    jm = JGrowthMLP((8, 8), 16)
    params = jm.init(jax.random.PRNGKey(0), x)
    jout, jacts = janalysis.capture_activations(jm, params, x)
    tm = load_flax_params(TGrowthMLP(5, (8, 8), 16), params)
    tout, tacts = tanalysis.capture_activations(tm, torch.from_numpy(x))
    assert set(tacts) == set(jacts)
    for key in jacts:
        np.testing.assert_allclose(tacts[key], np.asarray(jacts[key]),
                                   atol=1e-5, rtol=1e-5)
    stats = tanalysis.activation_stats(tacts)
    assert stats.keys() == janalysis.activation_stats(jacts).keys()


def test_activation_stats_match_jax(captured):
    _, acts = captured
    mask = np.ones(N, bool)
    mask[::7] = False
    got = tanalysis.activation_stats(acts, mask)
    want = janalysis.activation_stats(acts, mask)
    assert got == want
    assert all(np.isfinite(s["mean"]) for s in got.values())


# -- k-means and clusters

@pytest.mark.parametrize("k", [3, 8])
def test_kmeans_bit_for_bit(k):
    rng = np.random.RandomState(k)
    x = np.concatenate([rng.randn(60, 6) + 4 * rng.randn(6)
                        for _ in range(k)]).astype(np.float32)
    np.testing.assert_array_equal(tanalysis.kmeans(x, k, seed=k),
                                  janalysis.kmeans(x, k, seed=k))


def test_cluster_dump_matches_jax(captured, tiny, tmp_path):
    _, acts = captured
    layer = "encoder/global/__call__"
    xyz = tiny["args"][0]
    mask = np.ones(N, bool)
    mask[::5] = False
    paths = [tmp_path / "jax.txt", tmp_path / "torch.txt"]
    assigns = [mod.cluster_activations(acts, layer, k=8, mask=mask, xyz=xyz,
                                       dump_path=str(path))
               for mod, path in zip((janalysis, tanalysis), paths)]
    np.testing.assert_array_equal(assigns[1], assigns[0])
    assert set(np.unique(assigns[1][mask])) <= set(range(8))
    assert paths[1].read_bytes() == paths[0].read_bytes()
    lines = paths[1].read_text().splitlines()
    assert len(lines) == mask.sum() and len(lines[0].split()) == 6


# -- R11

class _Applied:
    """A flax model whose ``apply`` hands back what the jitted
    ``tiny_s3dis`` program returned for the same call (an eager flax apply
    of the model takes ~16 s here), so the JAX ``capture_activations``
    runs its own walk on the model's real intermediates."""

    def __init__(self, tiny):
        self.tiny = tiny

    def apply(self, params, *args, **kwargs):
        assert params is self.tiny["params"] and args[-1] is False
        assert kwargs == {"capture_intermediates": True,
                          "mutable": ["intermediates"]}
        return self.tiny["applied"]


def test_r11_jax_capture_raises_port_records_encoder_tuple(tiny, captured):
    with pytest.raises(ValueError, match="inhomogeneous"):
        janalysis.capture_activations(_Applied(tiny), tiny["params"],
                                      *tiny["args"], False)
    _, acts = captured
    assert "encoder/__call__" not in acts
    assert acts["encoder/__call__/0"].shape == (N, 512)
    assert acts["encoder/__call__/1"].shape == (N, 28)
