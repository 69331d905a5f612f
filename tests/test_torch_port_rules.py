"""Rules the port keeps as a package: it imports neither JAX nor the JAX
package (its host code is its own copy, and gives the same arrays), and its
entry points run on the card unless the caller asks for the CPU."""
import inspect
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from pointcloudsegmentation_tpu.data import batching as jbatching
from pointcloudsegmentation_tpu.data import native as jnative
from pointcloudsegmentation_tpu.data import toy as jtoy
from pointcloudsegmentation_tpu_torch import (ab_arms, bench,
                                              bench_fused_conv,
                                              conv_compare, eval_parity,
                                              interpolate, microbench,
                                              model_breakdown, parity_ab,
                                              profile_step, trace_step,
                                              verify_search_recall)
from pointcloudsegmentation_tpu_torch.data import batching as tbatching
from pointcloudsegmentation_tpu_torch.data import native as tnative
from pointcloudsegmentation_tpu_torch.data import toy as ttoy
from pointcloudsegmentation_tpu_torch.train import cli
from pointcloudsegmentation_tpu_torch.train.loop import Trainer
from pointcloudsegmentation_tpu_torch.train.model_zoo import build_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "pointcloudsegmentation_tpu_torch")

# imports every module of the port and chip_smoke.py's module-level code,
# then names whatever of JAX or the JAX package got imported
_PROBE = """
import importlib, pkgutil, sys
sys.path.insert(0, {root!r})
import pointcloudsegmentation_tpu_torch as port
walked = [m.name for m in pkgutil.walk_packages(port.__path__,
                                                port.__name__ + ".")]
for name in walked:
    importlib.import_module(name)
print(sorted(walked))
spec = importlib.util.spec_from_file_location("chip_smoke", {smoke!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(sorted(n for n in sys.modules if n in ("jax", "jaxlib", "flax")
             or n.split(".")[0] == "pointcloudsegmentation_tpu"))
"""
_IMPORT = re.compile(r"^\s*(import\s+(jax|jaxlib|flax|pointcloudsegmentation_tpu)"
                     r"\b|from\s+(jax|jaxlib|flax|pointcloudsegmentation_tpu)"
                     r"[\s.])")


def test_port_and_chip_smoke_import_no_jax():
    probe = _PROBE.format(root=ROOT, smoke=os.path.join(ROOT, "chip_smoke.py"))
    proc = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    *_, walked, jax_modules = proc.stdout.strip().splitlines()
    assert jax_modules == "[]", proc.stdout
    for name in ("train.cli", "interpolate", "parity_ab", "data.augment",
                 "data.io_util", "data.s3dis", "data.scannet",
                 "data.semantic3d", "data.synth_rooms", "data.provider",
                 "utils.logging", "models.ecd", "models.variants",
                 "models.gpn", "ops.anchors", "data.modelnet",
                 "models.template", "models.dense", "models.context",
                 "data.synth_outdoor", "prepare_data", "ops.interpolate",
                 "eval.interpolate", "parallel.mesh", "parallel.distributed",
                 "parallel.scene_shard", "dryrun", "halo_study",
                 "utils.viz", "utils.profiling", "eval.analysis",
                 "analysis_compare", "verify_search_recall", "profile_step",
                 "trace_step", "conv_compare", "eval_parity",
                 "ops.geometry", "bench", "ab_arms", "model_breakdown",
                 "microbench"):
        assert f"'pointcloudsegmentation_tpu_torch.{name}'" in walked, name


def test_port_sources_name_no_jax_import():
    """Imports inside functions too: no line of the port or of
    chip_smoke.py imports JAX or the JAX package."""
    files = [os.path.join(ROOT, "chip_smoke.py")] + [
        os.path.join(d, f) for d, _, fs in os.walk(PORT) for f in fs
        if f.endswith(".py")]
    bad = [f"{path}:{i}: {line.strip()}" for path in files
           for i, line in enumerate(open(path), 1) if _IMPORT.match(line)]
    assert len(files) > 30 and not bad, bad


@pytest.mark.parametrize("classes_feats", [(13, 12), (21, 5)])
def test_toy_copy_gives_the_jax_arrays(classes_feats):
    num_classes, feat_dim = classes_feats
    kw = dict(num_points=700, seed=3, num_classes=num_classes,
              feat_dim=feat_dim)
    want = list(jtoy.toy_batches(2, 3, kind="room", **kw))
    got = list(ttoy.toy_batches(2, 3, kind="room", **kw))
    for w, g in zip(want, got):
        assert w.keys() == g.keys()
        for key in w:
            assert g[key].dtype == w[key].dtype
            np.testing.assert_array_equal(g[key], w[key])
    w = jtoy.synthetic_room_block(np.random.RandomState(5), 1000,
                                  num_classes, feat_dim)
    g = ttoy.synthetic_room_block(np.random.RandomState(5), 1000,
                                  num_classes, feat_dim)
    for key in w:
        np.testing.assert_array_equal(g[key], w[key])


@pytest.mark.parametrize("name", ["toy_batches", "dense_batches",
                                  "synthetic_room_block",
                                  "toy_two_class_block"])
def test_toy_signatures_keep_the_jax_defaults(name):
    """A call that leaves an argument out gets JAX's blocks: the port's
    parameters and their defaults are the JAX function's."""
    def defaults(fn):
        return [(p.name, p.default)
                for p in inspect.signature(fn).parameters.values()]

    assert defaults(getattr(ttoy, name)) == defaults(getattr(jtoy, name))


# The port's modules with a JAX counterpart elsewhere than at the same
# path: the tools beside the JAX package's scripts, and the config module
def _counterparts():
    """(port module, JAX module) names of every module both sides have."""
    import pkgutil

    import pointcloudsegmentation_tpu_torch as port

    pairs = []
    for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
        rel = m.name[len(port.__name__) + 1:]
        jax_path = os.path.join(ROOT, "pointcloudsegmentation_tpu",
                                *rel.split("."))
        if rel == "config":
            pairs.append((m.name, "pointcloudsegmentation_tpu.train.config"))
        elif os.path.exists(jax_path + ".py") or os.path.isdir(jax_path):
            pairs.append((m.name, "pointcloudsegmentation_tpu." + rel))
        if os.path.exists(os.path.join(ROOT, "scripts", rel + ".py")):
            pairs.append((m.name, rel))   # imported from scripts/
    return pairs


# Defaults the port keeps apart from JAX's on purpose: (module, function,
# parameter) -> the reason, in one line
DEFAULTS_KEPT_APART = {
    ("pointcloudsegmentation_tpu_torch.utils.logging", "get_logger",
     "name"): "the port logs under its own root, pcs_torch, so a process "
              "that imports both packages keeps their handlers apart",
}


def _default(value):
    """A default as compared across the frameworks: a function by its name
    (the framework's own relu on either side), anything else by repr
    (dataclass specs of the same fields print alike)."""
    if callable(value) and not inspect.isclass(value) \
            and hasattr(value, "__name__"):
        return ("function", value.__name__)
    return repr(value)


def _import(name):
    """Import module ``name`` (a JAX script by its bare name), leaving the
    environment as it was: a script may set variables as it loads
    (scripts/halo_study.py sets PCS_DISABLE_WINDOWED), which must not reach
    the tests that follow."""
    import importlib

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    saved = dict(os.environ)
    try:
        return importlib.import_module(name)
    finally:
        os.environ.clear()
        os.environ.update(saved)


def _diverging_defaults(port_name, jax_name):
    """(function, parameter, JAX default, port default) of every public
    function and class of ``port_name`` whose JAX counterpart of the same
    name in ``jax_name`` has a parameter of the same name with another
    default (a parameter one side requires counts as differing)."""
    pm, jm = _import(port_name), _import(jax_name)
    found = []
    for name, pobj in sorted(vars(pm).items()):
        jobj = getattr(jm, name, None)
        if (name.startswith("_") or jobj is None
                or getattr(pobj, "__module__", None) != port_name
                or getattr(jobj, "__module__", None) != jax_name):
            continue
        try:
            psig, jsig = inspect.signature(pobj), inspect.signature(jobj)
        except (TypeError, ValueError):
            continue
        for p in psig.parameters.values():
            q = jsig.parameters.get(p.name)
            if q is not None and _default(p.default) != _default(q.default):
                found.append((name, p.name, q.default, p.default))
    return found


@pytest.mark.parametrize("port_name,jax_name", _counterparts(),
                         ids=lambda v: v)
def test_signatures_keep_the_jax_defaults(port_name, jax_name):
    """A call that leaves an argument out gets what JAX gives: for every
    public function and class that both packages have under the same module
    path (or the port's tool and its script), each parameter of the same
    name has the same default, except where ``DEFAULTS_KEPT_APART`` gives
    the reason."""
    found = [f for f in _diverging_defaults(port_name, jax_name)
             if (port_name,) + f[:2] not in DEFAULTS_KEPT_APART]
    assert not found, found


# the parameters a port function may lack: approx_max_k's tuning (the port
# selects exactly) and a flax module's own fields
PARAMS_LEFT_OUT = {"recall_target", "use_approx", "parent", "name"}


@pytest.mark.parametrize("port_name,jax_name,fn", [
    ("pointcloudsegmentation_tpu_torch.ops.search",
     "pointcloudsegmentation_tpu.ops.search", "windowed_multi_band_neighbors"),
    ("pointcloudsegmentation_tpu_torch.ops.search",
     "pointcloudsegmentation_tpu.ops.search", "band_neighbors_auto"),
    ("pointcloudsegmentation_tpu_torch.models.pointnet",
     "pointcloudsegmentation_tpu.models.pointnet", "PointNetSegEncoder"),
    ("pointcloudsegmentation_tpu_torch.verify_search_recall",
     "verify_search_recall", "windowed_band_recall")])
def test_search_entry_points_take_every_jax_parameter(port_name, jax_name,
                                                      fn):
    """The windowed search, its dispatch, the encoder and the recall tool
    take every parameter of their JAX counterparts but the approximate
    selection's (their defaults are held by the test above)."""
    jobj, pobj = getattr(_import(jax_name), fn), getattr(_import(port_name),
                                                          fn)
    want = set(inspect.signature(jobj).parameters) - PARAMS_LEFT_OUT
    assert want <= set(inspect.signature(pobj).parameters)


def test_defaults_kept_apart_still_differ():
    """Every entry of the allow-list names a default that still differs."""
    for (port_name, fn, param), why in DEFAULTS_KEPT_APART.items():
        jax_name = dict(_counterparts())[port_name]
        assert why and (fn, param) in [
            f[:2] for f in _diverging_defaults(port_name, jax_name)]


@pytest.mark.parametrize("n", [50, 130])   # padded, subsampled to 100 points
def test_batching_copy_gives_the_jax_arrays(n):
    rng = np.random.RandomState(n)
    inputs = [(rng.randn(m, 3).astype(np.float32),
               rng.randn(m, 4).astype(np.float32),
               rng.randint(0, 9, m).astype(np.int32)) for m in (n, 100)]
    blocks = {mod: [mod.pad_block(*x, 100, np.random.RandomState(i))
                    for i, x in enumerate(inputs)]
              for mod in (jbatching, tbatching)}
    for w, g in zip(blocks[jbatching], blocks[tbatching]):
        assert w.keys() == g.keys()
        for key in w:
            assert g[key].dtype == w[key].dtype
            np.testing.assert_array_equal(g[key], w[key])
    w = jbatching.stack_blocks(blocks[jbatching])
    g = tbatching.stack_blocks(blocks[tbatching])
    assert w.keys() == g.keys()
    for key in w:
        assert g[key].shape[:2] == (2, 100)
        np.testing.assert_array_equal(g[key], w[key])


def test_native_copy_builds_in_the_port_and_matches():
    """The port's binding builds ``csrc/pointutil.cpp`` into its own
    ``_build/`` and interpolates as the JAX package's binding does."""
    rng = np.random.RandomState(0)
    sxyz = rng.uniform(0, 3, (2000, 3)).astype(np.float32)
    sprobs = rng.dirichlet(np.ones(13), 2000).astype(np.float32)
    qxyz = rng.uniform(0, 3, (5000, 3)).astype(np.float32)
    got = tnative.interpolate_probs(sxyz, sprobs, qxyz, 6, 88.9, 0.3)
    assert os.path.dirname(tnative.LIB) == os.path.join(PORT, "_build")
    assert os.path.exists(tnative.LIB)
    jnative.ensure_built()
    want = jnative.interpolate_probs(sxyz, sprobs, qxyz, 6, 88.9, 0.3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("entry", ["build_model", "Trainer", "bench_setup"])
def test_entry_points_default_to_the_card(entry):
    fn = {"build_model": build_model, "Trainer": Trainer.__init__,
          "bench_setup": bench_fused_conv.setup}[entry]
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_bench_cli_defaults_to_the_card(monkeypatch):
    seen = {}

    class Stop(Exception):
        pass

    def setup(level, device):
        seen.update(level=level, device=device)
        raise Stop

    monkeypatch.setattr(bench_fused_conv, "setup", setup)
    with pytest.raises(Stop):
        bench_fused_conv.main(["--level", "1"])
    assert seen == {"level": 1, "device": "cuda"}


@pytest.mark.parametrize("entry", [
    "train.cli", "interpolate", "parity_ab", "verify_search_recall",
    "profile_step", "trace_step", "conv_compare", "eval_parity", "bench",
    "ab_arms", "model_breakdown", "microbench"])
def test_user_entry_points_default_to_the_card(entry, monkeypatch):
    """Without ``--device`` the CLIs ask for ``cuda`` and, with no card,
    raise instead of running on the CPU."""
    mod = {"train.cli": cli, "interpolate": interpolate,
           "parity_ab": parity_ab,
           "verify_search_recall": verify_search_recall,
           "profile_step": profile_step, "trace_step": trace_step,
           "conv_compare": conv_compare, "eval_parity": eval_parity,
           "bench": bench, "ab_arms": ab_arms,
           "model_breakdown": model_breakdown,
           "microbench": microbench}[entry]
    seen = []
    real = cli.require_device

    def require_device(device):
        seen.append(device)
        return real(device)

    monkeypatch.setattr(mod, "require_device", require_device)
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    argv = {"train.cli": ["--synthetic"], "interpolate": ["--synthetic"],
            "parity_ab": ["--epochs", "1"],
            "ab_arms": ['[{"label": "base"}]']}.get(entry, [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)
    assert seen == ["cuda"]
