"""End-to-end parity of the ported models with the JAX package, float32,
``train=False``, with the JAX weights converted by ``convert.py``:
``tiny_s3dis`` through the whole pipeline (Morton sort, pyramid, windowed
and global search, pooled overflow, factored head), and the flagship
encoder + head fed the JAX-built pyramid."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudsegmentation_tpu.data import toy
from pointcloudsegmentation_tpu.models import pointnet as jpointnet
from pointcloudsegmentation_tpu.models.layers import (SegClassifier,
                                                      set_compute_dtype)
from pointcloudsegmentation_tpu.ops import hierarchy as jhier
from pointcloudsegmentation_tpu.ops import morton as jmorton
from pointcloudsegmentation_tpu.train.config import s3dis_config as js3dis
from pointcloudsegmentation_tpu.train.config import \
    scannet_config as jscannet
from pointcloudsegmentation_tpu.train.model_zoo import build_model as jbuild
from pointcloudsegmentation_tpu_torch.config import s3dis_config as ts3dis
from pointcloudsegmentation_tpu_torch.config import \
    scannet_config as tscannet
from pointcloudsegmentation_tpu_torch.convert import (flax_to_state_dict,
                                                      load_flax_params)
from pointcloudsegmentation_tpu_torch.models import layers as tl
from pointcloudsegmentation_tpu_torch.models import pointnet as tpointnet
from pointcloudsegmentation_tpu_torch.ops.types import Level, Pyramid
from pointcloudsegmentation_tpu_torch.train.model_zoo import \
    build_model as tbuild

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)


def random_params(model, *args, seed=0):
    """Numpy weights shaped like ``model.init(...)`` (no init compile):
    Glorot-uniform kernels and small random biases."""
    return random_tree(jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), *args, False)), seed)


def random_tree(shapes, seed):
    """Glorot-uniform kernels and small random biases for a tree of
    parameter shapes."""
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
                           data_caps=caps), device="cpu",
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


def _t(a):
    return torch.from_numpy(np.array(a))


def _pyramids(xyz, feats, mask, caps):
    """Morton-sort a block and build the JAX pyramid; returns (JAX pyramid,
    the same pyramid as torch tensors, sorted feats)."""
    xyz, mask, _, feats = (np.array(a) for a in jmorton.sort_block(
        xyz, mask, 0.0375, 3.0, feats))
    jpyr = jax.jit(jhier.build_pyramid, static_argnums=(2, 3, 4, 5))(
        xyz, mask, (0.15, 0.45), caps, 3.0, True)
    tpyr = Pyramid(levels=tuple(Level(_t(lv.xyz), _t(lv.mask))
                                for lv in jpyr.levels),
                   seg=tuple(_t(s) for s in jpyr.seg),
                   dxyz=tuple(_t(d) for d in jpyr.dxyz), morton_sorted=True)
    return jpyr, tpyr, feats


def test_flagship_encoder_and_head(flagship):
    jmodel, params, (xyz, feats, mask), caps = flagship
    jpyr, tpyr, feats = _pyramids(xyz, feats, mask, caps)
    p = params["params"]
    z, lf = jmodel.encoder.apply({"params": p["encoder"]}, jpyr, feats)
    want = np.array(SegClassifier(13, premixed=True).apply(
        {"params": p["head"]}, z, lf, False))

    t = _t
    tmodel = tbuild(ts3dis(compute_dtype="float32", data_caps=caps),
                    device="cpu")
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
    tmodel = tbuild(ts3dis(compute_dtype="float32", data_caps=caps),
                    device="cpu")
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
        flax_to_state_dict({"x": {"moving_mean": np.ones(3, np.float32)}})
    # a trainable GPN conv's pmiu keeps its name (GPNConv(pmiu_trainable))
    assert set(flax_to_state_dict({"x": {"pmiu": np.ones(3, np.float32)}})
               ) == {"x.pmiu"}


def test_tiny_s3dis_bf16_end_to_end(monkeypatch):
    """bfloat16 compute on both sides, same converted weights: within 2^-6
    of the largest logit (K1's bf16 bound), argmax nearly everywhere."""
    monkeypatch.setenv("PCS_WIN_WINDOW", "64")
    n, caps = 512, (512, 128)
    jcfg = js3dis(model="tiny_s3dis", data_num_points=n, data_caps=caps)
    jmodel = jbuild(jcfg, search_chunk=512)
    xyz, feats, mask = _block(2, n, 40)
    params = random_params(jmodel, xyz, feats, mask, seed=2)
    set_compute_dtype(jnp.bfloat16)
    want = np.array(jmodel.apply(params, xyz, feats, mask, False))
    set_compute_dtype(None)
    assert want.dtype == jnp.bfloat16
    want = want.astype(np.float32)

    tmodel = tbuild(ts3dis(model="tiny_s3dis", compute_dtype="bfloat16",
                           data_caps=caps), device="cpu",
                    win_tile=64, win_window=64, search_chunk=512)
    load_flax_params(tmodel, params)
    with torch.no_grad():
        got = tmodel(_t(xyz), _t(feats), _t(mask))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    bound = 2.0 ** -6 * np.abs(want).max()
    assert np.abs(got - want).max() <= bound, (np.abs(got - want).max(),
                                               bound)
    assert (got.argmax(1) == want.argmax(1)).mean() >= 0.98


def _tiny_arch(jp, stage0_rescale):
    """tiny_s3dis's shape from module ``jp`` (the JAX or the port's
    pointnet), with stage 0's rescale given and its convs of radii 0.3 and
    0.2."""
    return jp.Arch(stages=(
        jp.StageSpec(rescale=stage0_rescale, convs=(
            jp.ConvSpec(radius=0.3, k=8, fc_dims=(4, 4), out=8),
            jp.ConvSpec(radius=0.2, k=6, embed=8, fc_dims=(4, 4), out=8),
        ), pool_fc_dims=(4, 4), pool_out=8),
        jp.StageSpec(rescale=0.9, convs=(
            jp.ConvSpec(radius=0.9, k=8, embed=8, fc_dims=(4, 4), out=8),
        ), pool_fc_dims=None),
    ), global_dims=(8, 8), global_out=16)


def test_sxyz_divided_by_conv_radius_when_stage_rescale_is_one():
    """A stage with ``rescale=1.0`` divides each conv's sxyz by the conv's
    own radius (JAX ``models/pointnet.py:575``), here 0.3 and 0.2."""
    n, caps = 512, (256, 64)
    xyz, feats, mask = _block(3, n, 30)
    jpyr, tpyr, feats = _pyramids(xyz, feats, mask, caps)
    jenc = jpointnet.PointNetSegEncoder(
        arch=_tiny_arch(jpointnet, 1.0), head_dim=512, win_tile=64,
        win_window=64, ov_pool_size=256, search_chunk=512)
    params = random_tree(jax.eval_shape(
        lambda: jenc.init(jax.random.PRNGKey(0), jpyr, feats)), seed=4)
    z, lf = jenc.apply(params, jpyr, feats)
    tenc = tpointnet.PointNetSegEncoder(
        12, arch=_tiny_arch(tpointnet, 1.0), head_dim=512, win_tile=64,
        win_window=64, ov_pool_size=256, search_chunk=512)
    load_flax_params(tenc, params)
    with torch.no_grad():
        tz, tlf = tenc(tpyr, _t(feats))
    np.testing.assert_allclose(tlf.numpy(), np.array(lf), **TOL)
    np.testing.assert_allclose(tz.numpy(), np.array(z), **TOL)


@pytest.fixture(scope="module")
def scannet():
    n, caps = 1024, (1024, 256)
    jmodel = jbuild(jscannet(data_num_points=n, data_caps=caps))
    xyz, _, mask = _block(4, n, 24)
    feats = np.zeros((n, 1), np.float32)   # the CLI's --synthetic width
    params = random_params(jmodel, xyz, feats, mask, seed=5)
    return jmodel, params, (xyz, feats, mask), caps


def test_pointnet_scannet_layer_by_layer(scannet):
    """``pointnet_scannet`` (xyz-only first conv whose output replaces the
    features, no avg-pooled cascade) against the JAX ``SCANNET_ARCH``
    encoder fed the JAX pyramid, float32: every child module's output
    (the 13 convs, the embeds, the pool MLPs, the global MLP, the head
    projections), then the encoder's outputs and the head's logits."""
    jmodel, params, (xyz, feats, mask), caps = scannet
    jpyr, tpyr, feats = _pyramids(xyz, feats, mask, caps)
    p = params["params"]
    (z, lf), inter = jax.jit(lambda v: jmodel.encoder.apply(
        v, jpyr, feats, capture_intermediates=True,
        mutable=["intermediates"]))({"params": p["encoder"]})
    inter = inter["intermediates"]
    want = np.array(SegClassifier(20, premixed=True).apply(
        {"params": p["head"]}, z, lf, False))

    tmodel = tbuild(tscannet(compute_dtype="float32", data_caps=caps),
                    device="cpu")
    load_flax_params(tmodel, params)
    assert isinstance(tmodel.encoder.feats0, tl.PointNetConv)
    outs = {}
    for name, mod in tmodel.encoder.named_children():
        mod.register_forward_hook(
            lambda m, a, out, name=name: outs.setdefault(name, out))
    with torch.no_grad():
        tz, tlf = tmodel.encoder(tpyr, _t(feats))
        got = tmodel.head(tz, tlf).numpy()
    # 13 convs, 10 embeds, 2 pool MLPs, the global MLP, 4 head projections
    assert len(outs) == 13 + 10 + 2 + 1 + 4
    for name, out in outs.items():
        np.testing.assert_allclose(out.numpy(),
                                   np.array(inter[name]["__call__"][0]),
                                   err_msg=name, **TOL)
    np.testing.assert_allclose(tlf.numpy(), np.array(lf), **TOL)
    np.testing.assert_allclose(tz.numpy(), np.array(z), **TOL)
    np.testing.assert_allclose(got, want, **TOL)


def test_pointnet_scannet_end_to_end(scannet):
    """The whole ``pointnet_scannet`` block pipeline (Morton sort, pyramid,
    the windowed search at level 0, the model) at 1024 points, float32."""
    jmodel, params, (xyz, feats, mask), caps = scannet
    want = np.array(jmodel.apply(params, xyz, feats, mask, False))
    tmodel = tbuild(tscannet(compute_dtype="float32", data_caps=caps),
                    device="cpu")
    load_flax_params(tmodel, params)
    with torch.no_grad():
        got = tmodel(_t(xyz), _t(feats), _t(mask)).numpy()
    assert got.shape == (1024, 20)
    np.testing.assert_allclose(got, want, **TOL)
