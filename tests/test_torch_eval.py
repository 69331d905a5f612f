"""The port's eval path against the JAX package's, and the port's import and
chip-smoke contracts."""
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import torch

from pointcloudsegmentation_tpu.data import toy
from pointcloudsegmentation_tpu.eval import interpolate as jeval
from pointcloudsegmentation_tpu.train.config import s3dis_config as js3dis
from pointcloudsegmentation_tpu.train.model_zoo import build_model as jbuild
from pointcloudsegmentation_tpu_torch.config import s3dis_config as ts3dis
from pointcloudsegmentation_tpu_torch.convert import load_flax_params
from pointcloudsegmentation_tpu_torch.eval import interpolate as teval
from pointcloudsegmentation_tpu_torch.train.model_zoo import \
    build_model as tbuild

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _blocks(n, count):
    rng = np.random.RandomState(0)
    out = []
    for i in range(count):
        b = toy.synthetic_room_block(rng, n=n)
        mask = np.ones(n, bool)
        mask[-17 * (i + 1):] = False
        out.append({"xyz": b["xyz"], "feats": b["feats"], "mask": mask,
                    "block_min": np.array([3.0 * i, 0, 0], np.float32)})
    return out


def test_eval_scene_probs_and_interpolation(monkeypatch):
    monkeypatch.setenv("PCS_WIN_WINDOW", "64")   # JAX: tile = window = 64
    n, caps = 512, (512, 128)
    jmodel = jbuild(js3dis(model="tiny_s3dis", data_num_points=n,
                           data_caps=caps), search_chunk=512)
    blocks = _blocks(n, 2)
    b0 = blocks[0]
    params = jmodel.init(jax.random.PRNGKey(0), b0["xyz"], b0["feats"],
                         b0["mask"], False)
    params = jax.tree_util.tree_map(np.array, params)
    apply_fn = jax.jit(lambda p, x, f, m: jmodel.apply(p, x, f, m, False))
    jxyz, jprobs = jeval.eval_scene_probs(apply_fn, params, blocks)

    tmodel = tbuild(ts3dis(model="tiny_s3dis", compute_dtype="float32",
                           data_caps=caps), device="cpu",
                    win_tile=64, win_window=64, search_chunk=512)
    load_flax_params(tmodel, params)
    txyz, tprobs = teval.eval_scene_probs(tmodel, blocks)
    assert tprobs.shape == (2 * n - 17 * 3, 13)
    np.testing.assert_array_equal(txyz, jxyz)
    np.testing.assert_allclose(tprobs, jprobs, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tprobs.sum(1), 1.0, atol=1e-5)

    rng = np.random.RandomState(1)
    dense = txyz[rng.randint(0, len(txyz), 2000)] \
        + rng.uniform(-0.05, 0.05, (2000, 3)).astype(np.float32)
    dp = teval.interpolate_to_dense(txyz, tprobs, dense, k=6)
    np.testing.assert_allclose(
        dp, jeval.interpolate_to_dense(jxyz, jprobs, dense, k=6),
        atol=1e-5, rtol=0)
    labels = rng.randint(0, 13, 2000)
    got = teval.scene_iou(labels, dp.argmax(1), 13)
    want = jeval.scene_iou(labels, dp.argmax(1), 13)
    np.testing.assert_allclose(got["iou"], want["iou"])
    assert got["miou"] == want["miou"]


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import pointcloudsegmentation_tpu_torch.config\n"
            "import pointcloudsegmentation_tpu_torch.convert\n"
            "import pointcloudsegmentation_tpu_torch.eval.interpolate\n"
            "import pointcloudsegmentation_tpu_torch.train.model_zoo\n"
            "import pointcloudsegmentation_tpu_torch.train.loop\n"
            "import pointcloudsegmentation_tpu_torch.train.checkpoint\n"
            "import pointcloudsegmentation_tpu_torch.train.metrics\n"
            "import pointcloudsegmentation_tpu_torch.data.provider\n"
            "import pointcloudsegmentation_tpu_torch.kernels.window_gather\n"
            "import pointcloudsegmentation_tpu_torch.profile_train\n"
            "bad =[m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax')]\n"
            "print('JAXFREE' if not bad else bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("JAXFREE"), out.stdout


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    """Alone in a directory the script exits non-zero and prints no result;
    so does it from the repo on a host with no CUDA device."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), alone)
    runs = [(str(alone), str(tmp_path))]
    if not torch.cuda.is_available():
        runs.append((os.path.join(ROOT, "chip_smoke.py"), ROOT))
    for script, cwd in runs:
        out = subprocess.run([sys.executable, script], cwd=cwd,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
