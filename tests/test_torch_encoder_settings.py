"""The encoder's search and conv settings in the port against the JAX
encoder cloned with the same field, float32, weights carried through
``convert.load_flax_params``: the flagship at 1024 points with the
windowed search's global selection over 64 candidates (``sel_mode=
"global", win_cand_k=64``, JAX's ``PCS_SEL_MODE=global PCS_CAND_K=64``)
and with the plain ``PointNetConv`` for every concat conv
(``fast_conv=False``), logits within 1e-4 of scale; ``remat=True`` on
``tiny_s3dis``, whose gradients at the encoder's outputs equal the port's
own ``remat=False`` bit for bit and JAX's ``remat=True`` within 1e-4 of
scale; and ``build_model``'s keywords reaching the encoder."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudsegmentation_tpu.ops import hierarchy as jhier
from pointcloudsegmentation_tpu.ops import morton as jmorton
from pointcloudsegmentation_tpu.train import config as jconfig
from pointcloudsegmentation_tpu.train.model_zoo import build_model as jbuild
from pointcloudsegmentation_tpu_torch import config as tconfig
from pointcloudsegmentation_tpu_torch.convert import (flax_to_state_dict,
                                                      load_flax_params)
from pointcloudsegmentation_tpu_torch.models.fast_conv import \
    PointNetConvFast
from pointcloudsegmentation_tpu_torch.models.layers import PointNetConv
from pointcloudsegmentation_tpu_torch.ops import hierarchy as thier
from pointcloudsegmentation_tpu_torch.ops import morton as tmorton
from pointcloudsegmentation_tpu_torch.train.model_zoo import \
    build_model as tbuild
from test_torch_archs import assert_close
from test_torch_model import _block, random_params

torch.set_num_threads(1)
N, CAPS = 1024, (1024, 256)     # levels 0 windowed, 1 and 2 global


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(autouse=True)
def _no_env_overrides(monkeypatch):
    """The JAX build and search read these; the port takes keywords."""
    for var in ("PCS_SEL_MODE", "PCS_CAND_K", "PCS_REMAT", "PCS_OV_POOL",
                "PCS_WIN_WINDOW", "PCS_DISABLE_WINDOWED"):
        monkeypatch.delenv(var, raising=False)


def _flagship_logits(seed, **fields):
    """The flagship built with ``fields`` on both sides, random flax
    weights: (JAX logits, port logits, port model) on one block."""
    jmodel = jbuild(jconfig.s3dis_config(data_num_points=N, data_caps=CAPS))
    jmodel = jmodel.clone(encoder=jmodel.encoder.clone(**fields))
    xyz, feats, mask = _block(seed, N, 30)
    params = random_params(jmodel, xyz, feats, mask, seed=seed)
    want = jax.jit(lambda p: jmodel.apply(p, xyz, feats, mask, False))(
        params)
    tmodel = tbuild(tconfig.s3dis_config(
        compute_dtype="float32", data_num_points=N, data_caps=CAPS),
        device="cpu", **fields)
    load_flax_params(tmodel, params)
    with torch.no_grad():
        got = tmodel(_t(xyz), _t(feats), _t(mask))
    return np.array(want), got.numpy(), tmodel


def test_flagship_global_selection():
    want, got, tmodel = _flagship_logits(1, sel_mode="global", win_cand_k=64)
    enc = tmodel.encoder
    assert (enc.sel_mode, enc.win_cand_k, enc.ov_pool_size) == \
        ("global", 64, 256)
    assert_close(got, want)


def test_flagship_plain_pointnet_conv():
    """``fast_conv=False``: every concat conv is the plain ``PointNetConv``
    under the flax conv's name, ``feats{i}``, and loads its weights."""
    want, got, tmodel = _flagship_logits(2, fast_conv=False)
    convs = [m for name, m in tmodel.encoder.named_children()
             if name.startswith("feats")]
    assert len(convs) == 13
    assert all(type(m) is PointNetConv and m.concat_growth for m in convs)
    assert_close(got, want)


def _encoder_grads(model, xyz, feats, mask, caps, wz, wl):
    """The gradient of a seeded weighting of the encoder's two outputs in
    every encoder parameter, on the Morton-sorted block's pyramid."""
    txs, tms, _, tfs = tmorton.sort_block(_t(xyz), _t(mask), 0.0375, 3.0,
                                          _t(feats))
    tpyr = thier.build_pyramid(txs, tms, (0.15, 0.45), caps, 3.0, True)
    model.zero_grad()
    z, lf = model.encoder(tpyr, tfs)
    ((z * _t(wz)).sum() + (lf * _t(wl)).sum()).backward()
    return {k: p.grad.clone() for k, p in model.encoder.named_parameters()}


def test_tiny_s3dis_remat():
    """``remat=True`` recomputes each concat conv in the backward: the same
    gradients as without it, bit for bit, and JAX's with ``nn.remat``
    within 1e-4 of scale.  The gradient stops at the encoder's outputs
    (the head's ReLU sits within float32 noise of 0 at this size)."""
    caps = (256, 64)
    jmodel = jbuild(jconfig.s3dis_config(
        model="tiny_s3dis", data_num_points=N, data_caps=caps))
    jmodel = jmodel.clone(encoder=jmodel.encoder.clone(remat=True))
    xyz, feats, mask = _block(3, N, 40)
    params = random_params(jmodel, xyz, feats, mask, seed=3)
    cfg = tconfig.s3dis_config(model="tiny_s3dis", compute_dtype="float32",
                               data_num_points=N, data_caps=caps)
    models = {}
    for remat in (True, False):
        models[remat] = load_flax_params(
            tbuild(cfg, device="cpu", remat=remat), params)
        assert models[remat].encoder.remat is remat
    xs, ms, _, fs = jmorton.sort_block(xyz, mask, 0.0375, 3.0, feats)
    jpyr = jhier.build_pyramid(xs, ms, (0.15, 0.45), caps, 3.0, True)
    rng = np.random.RandomState(4)
    wz = rng.randn(N, models[True].encoder.out_width).astype(np.float32)
    wl = rng.randn(N, models[True].encoder.stage0_width).astype(np.float32)
    wz[~np.array(ms)] = wl[~np.array(ms)] = 0.0

    def loss(p):
        z, lf = jmodel.encoder.apply({"params": p}, jpyr, fs)
        return jnp.sum(z * wz) + jnp.sum(lf * wl)

    want = flax_to_state_dict(jax.tree_util.tree_map(
        np.array, jax.jit(jax.grad(loss))(params["params"]["encoder"])))
    got = {r: _encoder_grads(m, xyz, feats, mask, caps, wz, wl)
           for r, m in models.items()}
    assert set(got[True]) == set(want)
    for k, g in want.items():
        assert torch.equal(got[True][k], got[False][k]), k
        assert np.abs(g.numpy()).max() > 0, k
        assert_close(got[True][k].numpy(), g.numpy(), k)


def test_build_model_passes_the_encoder_settings():
    """Every JAX build variable's keyword reaches the encoder (PCS_SEL_MODE
    -> sel_mode, PCS_CAND_K -> win_cand_k, PCS_OV_POOL -> ov_pool_size,
    PCS_REMAT -> remat), with the JAX build's defaults where left out; a
    typo in sel_mode raises."""
    cfg = tconfig.s3dis_config(model="tiny_s3dis", compute_dtype="float32",
                               data_num_points=N, data_caps=(256, 64))
    enc = tbuild(cfg, device="cpu").encoder
    assert (enc.cand_k, enc.win_cand_k, enc.ov_slots, enc.sel_mode,
            enc.ov_pool_size, enc.fast_conv, enc.remat, enc.head_dim) == \
        (64, 32, 8, "slab", 256, True, False, 512)
    kw = dict(cand_k=48, win_cand_k=64, ov_slots=4, sel_mode="global",
              ov_pool_size=0, fast_conv=False, remat=True)
    enc = tbuild(cfg, device="cpu", **kw).encoder
    assert {k: getattr(enc, k) for k in kw} == kw
    assert isinstance(enc.feats0, PointNetConv)
    assert isinstance(tbuild(cfg, device="cpu").encoder.feats0,
                      PointNetConvFast)
    with pytest.raises(ValueError, match="sel_mode"):
        tbuild(cfg, device="cpu", sel_mode="salb")
