"""End-to-end parity of the ported models with the JAX package, float32,
``train=False``, with the JAX weights converted by ``convert.py``:
``tiny_s3dis`` through the whole pipeline (Morton sort, pyramid, windowed
and global search, pooled overflow, factored head), and the flagship
encoder + head fed the JAX-built pyramid."""
import jax
import numpy as np
import pytest
import torch

from pointcloudsegmentation_tpu.data import toy
from pointcloudsegmentation_tpu.models.layers import SegClassifier
from pointcloudsegmentation_tpu.ops import hierarchy as jhier
from pointcloudsegmentation_tpu.ops import morton as jmorton
from pointcloudsegmentation_tpu.train.config import s3dis_config as js3dis
from pointcloudsegmentation_tpu.train.model_zoo import build_model as jbuild
from pointcloudsegmentation_tpu_torch.config import s3dis_config as ts3dis
from pointcloudsegmentation_tpu_torch.convert import (flax_to_state_dict,
                                                      load_flax_params)
from pointcloudsegmentation_tpu_torch.ops.types import Level, Pyramid
from pointcloudsegmentation_tpu_torch.train.model_zoo import \
    build_model as tbuild

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)


def random_params(model, *args, seed=0):
    """Numpy weights shaped like ``model.init(...)`` (no init compile):
    Glorot-uniform kernels and small random biases."""
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), *args, False))
    rng = np.random.RandomState(seed)

    def draw(path, s):
        if path[-1].key == "kernel":
            lim = np.sqrt(6.0 / (s.shape[0] + s.shape[1]))
            return rng.uniform(-lim, lim, s.shape).astype(np.float32)
        return rng.uniform(-0.1, 0.1, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _block(seed, n, n_pad):
    rng = np.random.RandomState(seed)
    b = toy.synthetic_room_block(rng, n=n)
    mask = np.ones(n, bool)
    mask[rng.choice(n, n_pad, replace=False)] = False
    xyz = b["xyz"].copy()
    xyz[~mask] = 0.0
    return xyz, b["feats"], mask


def test_tiny_s3dis_end_to_end(monkeypatch):
    monkeypatch.setenv("PCS_WIN_WINDOW", "64")   # JAX: tile = window = 64
    n, caps = 512, (512, 128)
    jcfg = js3dis(model="tiny_s3dis", data_num_points=n, data_caps=caps)
    jmodel = jbuild(jcfg, search_chunk=512)
    assert jmodel.encoder.win_tile == 64 and jmodel.encoder.win_window == 64
    xyz, feats, mask = _block(0, n, 40)
    params = random_params(jmodel, xyz, feats, mask)
    want = np.array(jmodel.apply(params, xyz, feats, mask, False))

    tmodel = tbuild(ts3dis(model="tiny_s3dis", compute_dtype="float32",
                           data_caps=caps),
                    win_tile=64, win_window=64, search_chunk=512)
    load_flax_params(tmodel, params)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(xyz), torch.from_numpy(feats),
                     torch.from_numpy(mask)).numpy()
    assert got.shape == (n, 13)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.fixture(scope="module")
def flagship():
    n, caps = 1024, (1024, 256)
    jmodel = jbuild(js3dis(data_num_points=n, data_caps=caps))
    xyz, feats, mask = _block(1, n, 24)
    params = random_params(jmodel, xyz, feats, mask, seed=1)
    return jmodel, params, (xyz, feats, mask), caps


def test_flagship_encoder_and_head(flagship):
    jmodel, params, (xyz, feats, mask), caps = flagship
    xyz, mask, _, feats = (np.array(a) for a in jmorton.sort_block(
        xyz, mask, 0.0375, 3.0, feats))
    jpyr = jax.jit(jhier.build_pyramid, static_argnums=(2, 3, 4, 5))(
        xyz, mask, (0.15, 0.45), caps, 3.0, True)
    p = params["params"]
    z, lf = jmodel.encoder.apply({"params": p["encoder"]}, jpyr, feats)
    want = np.array(SegClassifier(13, premixed=True).apply(
        {"params": p["head"]}, z, lf, False))

    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    tpyr = Pyramid(levels=tuple(Level(t(lv.xyz), t(lv.mask))
                                for lv in jpyr.levels),
                   seg=tuple(t(s) for s in jpyr.seg),
                   dxyz=tuple(t(d) for d in jpyr.dxyz), morton_sorted=True)
    tmodel = tbuild(ts3dis(compute_dtype="float32", data_caps=caps))
    load_flax_params(tmodel, params)
    with torch.no_grad():
        tz, tlf = tmodel.encoder(tpyr, t(feats))
        got = tmodel.head(tz, tlf).numpy()
    np.testing.assert_allclose(tz.numpy(), np.array(z), **TOL)
    np.testing.assert_allclose(tlf.numpy(), np.array(lf), **TOL)
    np.testing.assert_allclose(got, want, **TOL)


def test_flagship_convert_round_trip(flagship):
    _, params, _, caps = flagship
    leaves = jax.tree_util.tree_leaves_with_path(params)
    assert len(leaves) == 339
    assert sum(leaf.size for _, leaf in leaves) == 1_765_097
    tmodel = tbuild(ts3dis(compute_dtype="float32", data_caps=caps))
    load_flax_params(tmodel, params)
    sd = tmodel.state_dict()
    assert len(sd) == 339
    for path, leaf in leaves:
        names = [k.key for k in path][1:]
        key = ".".join(names[:-1] + [{"kernel": "weight",
                                      "bias": "bias"}[names[-1]]])
        got = sd[key].numpy()
        np.testing.assert_array_equal(got.T if names[-1] == "kernel"
                                      else got, leaf)
    # a leaf left unmapped on either side raises
    bad = flax_to_state_dict(params)
    bad.pop("head.class_mlp3.bias")
    with pytest.raises(RuntimeError):
        tmodel.load_state_dict(bad, strict=True)
    with pytest.raises(KeyError):
        flax_to_state_dict({"x": {"scale": np.ones(3, np.float32)}})
