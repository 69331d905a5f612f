"""The rest of the PointNet family against the JAX package, float32,
``train=False``, with the JAX weights converted by ``convert.py``: the two
Semantic3D nets here (the level-1 pre-stage conv and the per-conv sxyz
divisor) and the unfactored concat decoder here, the S3DIS ablations in
``test_torch_archs_s3dis.py``.  Each key is held layer by layer on the
JAX-built pyramid where it brings a new module, end to end through the
whole block pipeline, and through a ``convert`` round trip under
``strict=True``."""
import jax
import numpy as np
import pytest
import torch

from pointcloudsegmentation_tpu.data import toy
from pointcloudsegmentation_tpu.models import pointnet as jpointnet
from pointcloudsegmentation_tpu.models.layers import SegClassifier
from pointcloudsegmentation_tpu.ops import hierarchy as jhier
from pointcloudsegmentation_tpu.ops import morton as jmorton
from pointcloudsegmentation_tpu.train import config as jconfig
from pointcloudsegmentation_tpu.train.model_zoo import build_model as jbuild
from pointcloudsegmentation_tpu_torch import config as tconfig
from pointcloudsegmentation_tpu_torch.convert import (flax_to_state_dict,
                                                      load_flax_params)
from pointcloudsegmentation_tpu_torch.models import layers as tl
from pointcloudsegmentation_tpu_torch.models import pointnet as tpointnet
from pointcloudsegmentation_tpu_torch.ops.types import Level, Pyramid
from pointcloudsegmentation_tpu_torch.train.model_zoo import \
    build_model as tbuild
from test_torch_model import (TOL, _block, _pyramids, _tiny_arch,
                              random_params, random_tree)

torch.set_num_threads(1)
N, CAPS = 1024, (1024, 256)


def assert_close(got, want, err_msg=""):
    """``got`` within TOL (1e-4) of ``want`` once both are divided by
    max(1, the largest |want|): float32 reorder noise grows with the
    magnitude of the summed terms, and these nets without an embed
    bottleneck reach activations and logits of about 100 under random
    weights (about 1.5e-6 of that apart, measured)."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale,
                               err_msg=err_msg, **TOL)


def _t(a):
    return torch.from_numpy(np.array(a))


def make_case(config, model, seed):
    """(JAX model, its random weights, a block, the port's float32 config)
    for ``model`` under the config preset named ``config`` at 1024 points
    with caps (1024, 256): a toy room block with the config's feature
    width and 24 padded points."""
    over = dict(model=model, data_num_points=N, data_caps=CAPS)
    jcfg = getattr(jconfig, f"{config}_config")(**over)
    tcfg = tconfig.CONFIGS[config](compute_dtype="float32", **over)
    d = jcfg.data
    rng = np.random.RandomState(seed)
    b = toy.synthetic_room_block(rng, n=N, num_classes=d.num_classes,
                                 feat_dim=d.feat_dim)
    mask = np.ones(N, bool)
    mask[rng.choice(N, 24, replace=False)] = False
    xyz = b["xyz"].copy()
    xyz[~mask] = 0.0
    jmodel = jbuild(jcfg)
    params = random_params(jmodel, xyz, b["feats"], mask, seed=seed)
    return jmodel, params, (xyz, b["feats"], mask), tcfg


def pyramids(block, cfg):
    """Morton-sort a block and build the JAX pyramid under ``cfg``'s voxel
    sizes, caps and block size; returns (JAX pyramid, the same pyramid as
    torch tensors, sorted feats)."""
    d = cfg.data
    xyz, feats, mask = block
    xyz, mask, _, feats = (np.array(a) for a in jmorton.sort_block(
        xyz, mask, d.voxel_sizes[0] / 4.0, d.block_size, feats))
    jpyr = jax.jit(jhier.build_pyramid, static_argnums=(2, 3, 4, 5))(
        xyz, mask, tuple(d.voxel_sizes), tuple(d.caps), d.block_size, True)
    tpyr = Pyramid(levels=tuple(Level(_t(lv.xyz), _t(lv.mask))
                                for lv in jpyr.levels),
                   seg=tuple(_t(s) for s in jpyr.seg),
                   dxyz=tuple(_t(d) for d in jpyr.dxyz), morton_sorted=True)
    return jpyr, tpyr, feats


def layer_by_layer(case, children):
    """The port's encoder on the JAX pyramid against the JAX encoder:
    every child module's output (captured by forward hooks against flax's
    ``capture_intermediates``), the encoder's two outputs, and the head's
    logits.  ``children`` is the expected number of child modules."""
    jmodel, params, block, cfg = case
    jpyr, tpyr, feats = pyramids(block, cfg)
    p = params["params"]
    (z, lf), inter = jax.jit(lambda v: jmodel.encoder.apply(
        v, jpyr, feats, capture_intermediates=True,
        mutable=["intermediates"]))({"params": p["encoder"]})
    inter = inter["intermediates"]
    want = np.array(SegClassifier(
        cfg.data.num_classes, premixed=jmodel.head_premixed).apply(
        {"params": p["head"]}, z, lf, False))

    tmodel = tbuild(cfg, device="cpu")
    load_flax_params(tmodel, params)
    outs = {}
    for name, mod in tmodel.encoder.named_children():
        mod.register_forward_hook(
            lambda m, a, out, name=name: outs.setdefault(name, out))
    with torch.no_grad():
        tz, tlf = tmodel.encoder(tpyr, _t(feats))
        got = tmodel.head(tz, tlf).numpy()
    assert len(outs) == children, sorted(outs)
    for name, out in outs.items():
        assert_close(out.numpy(), inter[name]["__call__"][0], name)
    assert_close(tlf.numpy(), lf)
    assert_close(tz.numpy(), z)
    assert_close(got, want)
    return tmodel


def end_to_end(case):
    """The whole block pipeline (Morton sort, pyramid, windowed search at
    level 0, global search at level 1 and 2, the model) against the JAX
    model's logits."""
    jmodel, params, (xyz, feats, mask), cfg = case
    want = np.array(jmodel.apply(params, xyz, feats, mask, False))
    tmodel = tbuild(cfg, device="cpu")
    load_flax_params(tmodel, params)
    with torch.no_grad():
        got = tmodel(_t(xyz), _t(feats), _t(mask)).numpy()
    assert got.shape == (N, cfg.data.num_classes)
    assert np.isfinite(got).all()
    assert_close(got, want)


def round_trip(case):
    """Every flax leaf maps to one torch key with its value (kernels
    transposed), and no key is left over on either side."""
    _, params, _, cfg = case
    leaves = jax.tree_util.tree_leaves_with_path(params)
    tmodel = tbuild(cfg, device="cpu")
    load_flax_params(tmodel, params)
    sd = tmodel.state_dict()
    assert len(sd) == len(leaves)
    assert sum(v.numel() for v in sd.values()) == \
        sum(leaf.size for _, leaf in leaves)
    for path, leaf in leaves:
        names = [k.key for k in path][1:]
        key = ".".join(names[:-1] + [{"kernel": "weight",
                                      "bias": "bias"}[names[-1]]])
        got = sd[key].numpy()
        np.testing.assert_array_equal(got.T if names[-1] == "kernel"
                                      else got, leaf)
    bad = flax_to_state_dict(params)
    bad.pop(next(iter(bad)))
    with pytest.raises(RuntimeError):
        tmodel.load_state_dict(bad, strict=True)
    return tmodel


@pytest.fixture(scope="module")
def semantic3d():
    return make_case("semantic3d", "pointnet_semantic3d", 11)


@pytest.fixture(scope="module")
def semantic3d_dilate():
    return make_case("semantic3d", "pointnet_semantic3d_dilate", 12)


def test_pointnet_semantic3d_layer_by_layer(semantic3d):
    """The pre-stage (``feats_pre`` on level 1's avg-pooled 13 features,
    unpooled and prepended to level 0's) and the stages whose rescale of
    1.0 divides each conv's sxyz by its radius."""
    tmodel = layer_by_layer(semantic3d, 1 + 10 + 10 + 2 + 1 + 4)
    assert isinstance(tmodel.encoder.feats_pre, tl.PointNetConv)
    assert tmodel.encoder.feats_pre.fc_0.in_features == 2 * 13 + 3


def test_pointnet_semantic3d_end_to_end(semantic3d):
    end_to_end(semantic3d)


def test_pointnet_semantic3d_dilate_end_to_end(semantic3d_dilate):
    end_to_end(semantic3d_dilate)


@pytest.mark.parametrize("key", ["semantic3d", "semantic3d_dilate"])
def test_semantic3d_convert_round_trip(key, request):
    case = request.getfixturevalue(key)
    tmodel = round_trip(case)
    assert tmodel.head.premixed and not hasattr(tmodel.head, "class_mlp1")


def test_unfactored_concat_decoder():
    """``head_dim=None`` on the concat decoder returns the wide
    ``[unpool(lf) ‖ stage feats]`` concat, as the JAX encoder without its
    factored head does, and the unfactored head maps it."""
    n, caps = 512, (256, 64)
    xyz, feats, mask = _block(5, n, 30)
    jpyr, tpyr, feats = _pyramids(xyz, feats, mask, caps)
    jenc = jpointnet.PointNetSegEncoder(
        arch=_tiny_arch(jpointnet, 0.3), head_dim=None, win_tile=64,
        win_window=64, ov_pool_size=256, search_chunk=512)
    params = random_tree(jax.eval_shape(
        lambda: jenc.init(jax.random.PRNGKey(0), jpyr, feats)), seed=6)
    lf, sf = jenc.apply(params, jpyr, feats)
    head = SegClassifier(13)
    hparams = random_tree(jax.eval_shape(lambda: head.init(
        jax.random.PRNGKey(0), lf, sf, False)), seed=7)
    want = np.array(head.apply(hparams, lf, sf, False))

    tenc = tpointnet.PointNetSegEncoder(
        12, arch=_tiny_arch(tpointnet, 0.3), head_dim=None, win_tile=64,
        win_window=64, ov_pool_size=256, search_chunk=512)
    load_flax_params(tenc, params)
    assert tenc.out_width == lf.shape[-1]
    thead = load_flax_params(tl.SegClassifier(
        13, tenc.out_width, tenc.stage0_width, premixed=False), hparams)
    with torch.no_grad():
        tlf, tsf = tenc(tpyr, _t(feats))
        got = thead(tlf, tsf).numpy()
    assert_close(tlf.numpy(), lf)
    assert_close(tsf.numpy(), sf)
    assert_close(got, want)
