"""The ECD family of the port against the JAX package, float32,
``train=False``, JAX weights converted by ``convert.py``: the ECD layers
one at a time on a per-point-overflow windowed neighborhood, then
``ECDSegModel``'s five keys (``ecd_scannet``, ``ecd_s3dis``, ``pgnet_v3``,
``pgnet_v4``, ``pgnet_v5``) layer by layer, end to end and through a
``strict=True`` convert round trip.  The helpers here serve
``test_torch_pgnet.py`` as well.

Every comparison divides by max(1, the largest |JAX output|) and then
holds 1e-4 (``assert_close``): the nets stack tanh edge weights and concat
growth up to 18 layers deep, and float32 reorder noise grows with the
magnitude of the summed terms.  Blocks have 1024 points and caps (1024,
256), so levels 0 and 1 take the windowed search with per-point overflow
slots and level 2 the global one."""
import jax
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from pointcloudsegmentation_tpu.data import toy
from pointcloudsegmentation_tpu.models import ecd as jecd
from pointcloudsegmentation_tpu.models import layers as jlayers
from pointcloudsegmentation_tpu.models import variants as jvariants
from pointcloudsegmentation_tpu.ops import morton as jmorton
from pointcloudsegmentation_tpu.ops import search as jsearch
from pointcloudsegmentation_tpu.train import config as jconfig
from pointcloudsegmentation_tpu.train.model_zoo import build_model as jbuild
from pointcloudsegmentation_tpu_torch import config as tconfig
from pointcloudsegmentation_tpu_torch.convert import (flax_to_state_dict,
                                                      load_flax_params,
                                                      ravel_layout,
                                                      ravel_params)
from pointcloudsegmentation_tpu_torch.models import ecd as tecd
from pointcloudsegmentation_tpu_torch.models import layers as tlayers
from pointcloudsegmentation_tpu_torch.models import variants as tvariants
from pointcloudsegmentation_tpu_torch.ops.types import WindowedNeighborhood
from pointcloudsegmentation_tpu_torch.train.model_zoo import \
    build_model as tbuild
from test_torch_archs import assert_close
from test_torch_model import random_params, random_tree

torch.set_num_threads(1)
N, CAPS = 1024, (1024, 256)


def _t(a):
    return torch.from_numpy(np.array(a))


# -- whole models ------------------------------------------------------------

def config_of(key):
    return "scannet" if key == "ecd_scannet" else "s3dis"


def run_jax(key, seed):
    """The JAX model of ``key`` at 1024 points with random weights on a toy
    room block (the config's feature width, 24 padded points): its logits
    and every module's output (flax ``capture_intermediates``)."""
    over = dict(model=key, data_num_points=N, data_caps=CAPS)
    jcfg = getattr(jconfig, f"{config_of(key)}_config")(**over)
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
    logits, inter = jax.jit(lambda p: jmodel.apply(
        p, xyz, b["feats"], mask, False, capture_intermediates=True,
        mutable=["intermediates"]))(params)
    return dict(key=key, params=params, block=(xyz, b["feats"], mask),
                logits=np.array(logits), inter=inter["intermediates"],
                cfg=tconfig.CONFIGS[config_of(key)](
                    compute_dtype="float32", **over))


def port_model(case):
    tmodel = tbuild(case["cfg"], device="cpu")
    load_flax_params(tmodel, case["params"])
    return tmodel


def layer_by_layer(case):
    """Every module of the port's encoder and head (the encoder itself
    included) against the flax module of the same path, on the whole
    pipeline: forward hooks against ``capture_intermediates``."""
    tmodel = port_model(case)
    outs = {}
    for root in ("encoder", "head"):
        for name, mod in getattr(tmodel, root).named_modules(prefix=root):
            mod.register_forward_hook(
                lambda m, a, out, name=name: outs.setdefault(name, out))
    with torch.no_grad():
        tmodel(*(_t(a) for a in case["block"]))
    for name, out in outs.items():
        node = case["inter"]
        for part in name.split("."):
            node = node[part]
        want = node["__call__"][0]
        got = out if isinstance(out, tuple) else (out,)
        want = want if isinstance(want, tuple) else (want,)
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            assert g.shape == w.shape, (name, g.shape, w.shape)
            assert_close(g.numpy(), w, name)
    return tmodel, outs


def end_to_end(case):
    tmodel = port_model(case)
    with torch.no_grad():
        got = tmodel(*(_t(a) for a in case["block"])).numpy()
    assert got.shape == case["logits"].shape
    assert np.isfinite(got).all()
    assert_close(got, case["logits"])
    return tmodel


def round_trip(case):
    """Each flax leaf maps to one torch key with its value (a Dense kernel
    transposed; biases, ``scale`` and ``edge_weights_trans`` as they are),
    nothing is left over on either side, a missing key fails the strict
    load, and ``ravel_layout`` lays the parameters out in
    ``ravel_pytree``'s order, so the JAX trainer's flat Adam moments load
    as plain copies."""
    params = case["params"]
    tmodel = port_model(case)
    sd = tmodel.state_dict()
    leaves = jax.tree_util.tree_leaves_with_path(params)
    assert len(sd) == len(leaves)
    kinds = set()
    for path, leaf in leaves:
        names = [k.key for k in path][1:]
        kinds.add(names[-1])
        key = ".".join(names[:-1] + [
            "weight" if names[-1] == "kernel" else names[-1]])
        got = sd[key].numpy()
        np.testing.assert_array_equal(
            got.T if names[-1] == "kernel" else got, leaf, err_msg=key)
    np.testing.assert_array_equal(
        ravel_params(tmodel, ravel_layout(tmodel)).numpy(),
        np.array(ravel_pytree(params)[0]))
    bad = flax_to_state_dict(params)
    bad.pop(next(iter(bad)))
    with pytest.raises(RuntimeError):
        tmodel.load_state_dict(bad, strict=True)
    return tmodel, kinds


class Cases:
    """Module-scoped cache of ``run_jax`` results, one per key."""

    def __init__(self, keys, seed0):
        self.keys, self.seed0, self.done = keys, seed0, {}

    def __call__(self, key):
        if key not in self.done:
            self.done[key] = run_jax(key, self.seed0 + self.keys.index(key))
        return self.done[key]


ECD_KEYS = ("ecd_scannet", "ecd_s3dis", "pgnet_v3", "pgnet_v4", "pgnet_v5")


@pytest.fixture(scope="module")
def cases():
    return Cases(ECD_KEYS, 40)


@pytest.mark.parametrize("key", ECD_KEYS)
def test_layer_by_layer(cases, key):
    tmodel, outs = layer_by_layer(cases(key))
    enc = tmodel.encoder
    assert isinstance(enc, tecd.ECDSegModel) and enc.head_dim is None
    assert isinstance(enc.stage0.xyz_gc, tlayers.ECDConv)
    assert enc.stage0.xyz_gc.use_xyz_only
    spec = enc.specs[1]
    # every stage's convs, and every Dense of the head with class_mlp1
    assert f"encoder.stage1.gc_{len(spec.gc_dims) - 1}.fc_out" in outs
    assert "head.class_mlp1" in outs


@pytest.mark.parametrize("key", ECD_KEYS)
def test_end_to_end(cases, key):
    tmodel = end_to_end(cases(key))
    assert not tmodel.head.premixed
    assert tmodel.head.class_mlp1.in_features == tmodel.encoder.out_width


@pytest.mark.parametrize("key", ECD_KEYS)
def test_convert_round_trip(cases, key):
    _, kinds = round_trip(cases(key))
    assert kinds == {"kernel", "bias"}


def test_ecd_scannet_reads_no_input_features(cases):
    case = cases("ecd_scannet")
    assert case["block"][1].shape == (N, 0)
    assert port_model(case).encoder.stage0.fc_0.in_features == 16


# -- single layers on a per-point-overflow windowed neighborhood --------------

@pytest.fixture(scope="module")
def nbr():
    """The JAX windowed neighborhood (band (0, 0.15, 16), candidate pool
    64, per-point overflow) of a sorted 1024-point toy block with 40
    padded points, the same neighborhood as the port's type, sxyz / 0.15,
    12-wide features and the mask."""
    rng = np.random.RandomState(9)
    b = toy.synthetic_room_block(rng, n=N)
    mask = np.ones(N, bool)
    mask[rng.choice(N, 40, replace=False)] = False
    xyz = b["xyz"].copy()
    xyz[~mask] = 0.0
    xyz, mask, _, feats = (np.array(a) for a in jmorton.sort_block(
        xyz, mask, 0.0375, 3.0, b["feats"]))
    (jn, sxyz), = jsearch.windowed_multi_band_neighbors(
        xyz, mask, ((0.0, 0.15, 16),), tile=256, window=256, cand_k=64,
        ov_slots=8, chunk=1024, return_sxyz=True, ov_pool_size=0,
        sel_mode="slab")
    assert np.array(jn.ov_mask).any()
    tn = WindowedNeighborhood(
        lidx=_t(jn.lidx), wmask=_t(jn.wmask), ov_idx=_t(jn.ov_idx),
        ov_mask=_t(jn.ov_mask), window=256, tile=256)
    sxyz = np.array(sxyz) / 0.15
    return dict(jn=jn, tn=tn, sxyz=sxyz, feats=feats, mask=mask)


def _layer_case(jmod, tmod, args, targs, seed):
    """Random flax weights for ``jmod`` on ``args``, loaded into ``tmod``;
    its output against the flax module's."""
    params = random_tree(jax.eval_shape(
        lambda: jmod.init(jax.random.PRNGKey(0), *args)), seed)
    want = np.array(jax.jit(lambda p: jmod.apply(p, *args))(params))
    tmod.load_state_dict(flax_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = tmod(*targs).numpy()
    assert got.shape == want.shape
    assert_close(got, want)
    return got


def test_ecd_conv(nbr):
    a = (nbr["sxyz"], nbr["feats"], nbr["jn"])
    ta = (_t(nbr["sxyz"]), _t(nbr["feats"]), nbr["tn"])
    _layer_case(jlayers.ECDConv((8, 8), (8, 8), 16), tlayers.ECDConv(
        12, (8, 8), (8, 8), 16), a, ta, 1)


def test_ecd_conv_xyz_only(nbr):
    a = (nbr["sxyz"], None, nbr["jn"])
    ta = (_t(nbr["sxyz"]), None, nbr["tn"])
    tmod = tlayers.ECDConv(0, (8, 8), (8, 8), 16, use_xyz_only=True)
    assert tmod.fc_ew.out_features == 3 + 16
    _layer_case(jlayers.ECDConv((8, 8), (8, 8), 16, use_xyz_only=True),
                tmod, a, ta, 2)


def test_ecd_feats_v4(nbr):
    a = (nbr["sxyz"], nbr["feats"], nbr["jn"])
    ta = (_t(nbr["sxyz"]), _t(nbr["feats"]), nbr["tn"])
    tmod = tvariants.ECDFeatsV4(12, (16,), 16)
    assert tmod.edge_weights_trans.shape == (1, 12)
    _layer_case(jvariants.ECDFeatsV4((16,), 16), tmod, a, ta, 3)


def test_mlp_anchor_conv(nbr):
    a = (nbr["sxyz"], nbr["feats"], nbr["jn"])
    ta = (_t(nbr["sxyz"]), _t(nbr["feats"]), nbr["tn"])
    tmod = tecd.MLPAnchorConv(12, (16,), 16, 9)
    assert tmod.edge_weights_trans.shape == (1, 1, 9)
    _layer_case(jecd.MLPAnchorConv((16,), 16, 9), tmod, a, ta, 4)


def test_ecd_xyz_v2(nbr):
    a = (nbr["sxyz"], nbr["jn"], nbr["mask"])
    ta = (_t(nbr["sxyz"]), nbr["tn"], _t(nbr["mask"]))
    _layer_case(jvariants.ECDXyzV2((8, 8), 16, (8, 8), (8, 8), 32),
                tvariants.ECDXyzV2((8, 8), 16, (8, 8), (8, 8), 32), a, ta, 5)


def test_ecd_feats_v2(nbr):
    a = (nbr["sxyz"], nbr["feats"], nbr["jn"], nbr["mask"])
    ta = (_t(nbr["sxyz"]), _t(nbr["feats"]), nbr["tn"], _t(nbr["mask"]))
    _layer_case(jvariants.ECDFeatsV2(16, (8, 8), (8, 8), 32),
                tvariants.ECDFeatsV2(12, 16, (8, 8), (8, 8), 32), a, ta, 6)


def test_masked_batch_norm(nbr):
    """Statistics over the valid rows only: garbage in the padded rows
    changes nothing on the valid ones."""
    mask = nbr["mask"]
    x = np.random.RandomState(7).randn(N, 24).astype(np.float32) * 3 + 1
    got = _layer_case(jvariants.MaskedBatchNorm(),
                      tvariants.MaskedBatchNorm(24), (x, mask),
                      (_t(x), _t(mask)), 8)
    x2 = x.copy()
    x2[~mask] = 1e4
    tmod = tvariants.MaskedBatchNorm(24)
    with torch.no_grad():
        a = tmod(_t(x), _t(mask))[_t(mask)]
        b = tmod(_t(x2), _t(mask))[_t(mask)]
    assert torch.equal(a, b) and np.isfinite(got).all()
