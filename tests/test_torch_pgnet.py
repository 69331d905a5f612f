"""The PGNet models and the PointNet++ baseline of the port against the
JAX package (helpers and tolerances in ``test_torch_ecd.py``): ``pgnet_v6``
(``ECDStageV2``, ``ECDXyzV2``, ``ECDFeatsV2``, ``MaskedBatchNorm``),
``pgnet_v7`` (``ECDFeatsV4``), ``pgnet_v8`` (``MLPAnchorConv``) and
``pointnet2_s3dis``, each layer by layer, end to end and through a
``strict=True`` convert round trip at 1024 points; and one training step
on ``pgnet_v8`` (``edge_weights_trans``) and ``pgnet_v6``
(``MaskedBatchNorm``): the ``train=False`` loss to rel 1e-4 and the flat
gradient to 1e-4 through ``flax_train_state_to_torch``."""
import jax
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

from pointcloudsegmentation_tpu.data import toy
from pointcloudsegmentation_tpu.train.config import s3dis_config as js3dis
from pointcloudsegmentation_tpu.train.loop import TrainState as JState
from pointcloudsegmentation_tpu.train.loop import \
    make_lr_schedule as jschedule
from pointcloudsegmentation_tpu.train.loop import seg_loss as jseg_loss
from pointcloudsegmentation_tpu.train.model_zoo import build_model as jbuild
from pointcloudsegmentation_tpu_torch.config import s3dis_config as ts3dis
from pointcloudsegmentation_tpu_torch.convert import \
    flax_train_state_to_torch
from pointcloudsegmentation_tpu_torch.models import ecd as tecd
from pointcloudsegmentation_tpu_torch.models import variants as tvariants
from pointcloudsegmentation_tpu_torch.models.layers import PointNetConv
from pointcloudsegmentation_tpu_torch.models.pointnet import \
    PointNet2Baseline
from pointcloudsegmentation_tpu_torch.train.loop import Trainer
from test_torch_ecd import (CAPS, N, Cases, end_to_end, layer_by_layer,
                            round_trip)
from test_torch_model import random_params

torch.set_num_threads(1)

KEYS = ("pgnet_v6", "pgnet_v7", "pgnet_v8", "pointnet2_s3dis")
ENCODERS = {"pgnet_v6": tecd.PGNetV6, "pgnet_v7": tecd.PGNetV7,
            "pgnet_v8": tecd.PGNetHybrid,
            "pointnet2_s3dis": PointNet2Baseline}
# the non-Dense leaves each key carries
EXTRA_LEAVES = {"pgnet_v6": {"scale"}, "pgnet_v7": {"edge_weights_trans"},
                "pgnet_v8": {"edge_weights_trans"},
                "pointnet2_s3dis": {"edge_weights_trans"}}


@pytest.fixture(scope="module")
def cases():
    return Cases(KEYS, 60)


@pytest.mark.parametrize("key", KEYS)
def test_layer_by_layer(cases, key):
    tmodel, outs = layer_by_layer(cases(key))
    enc = tmodel.encoder
    assert type(enc) is ENCODERS[key] and enc.head_dim is None
    if key == "pgnet_v6":
        assert isinstance(enc.stage0.xyz.out_bn, tvariants.MaskedBatchNorm)
        assert "encoder.stage2.feats_2.out_bn" in outs
    elif key == "pgnet_v7":
        assert isinstance(enc.ecd10, tvariants.ECDFeatsV4)
        assert isinstance(enc.feats4, PointNetConv)
    elif key == "pgnet_v8":
        assert "encoder.anchor_conv9.fc_out" in outs
    else:
        assert isinstance(enc.anchor9, tecd.MLPAnchorConv)
        assert "encoder.pn7b.fc_out" in outs


@pytest.mark.parametrize("key", KEYS)
def test_end_to_end(cases, key):
    tmodel = end_to_end(cases(key))
    assert tmodel.head.class_mlp1.in_features == tmodel.encoder.out_width
    assert tmodel.head.class_mlp2.in_features == \
        512 + tmodel.encoder.stage0_width


@pytest.mark.parametrize("key", KEYS)
def test_convert_round_trip(cases, key):
    tmodel, kinds = round_trip(cases(key))
    assert kinds == {"kernel", "bias"} | EXTRA_LEAVES[key]


def test_pgnet_v6_binds_stage_outputs_swapped():
    """ECDStageV2 returns (cfeats, fc_final), which pgnet_v6 binds as (fc,
    lf) as the reference does: the stage-0 features the head concatenates
    are the 128-wide ``final_global`` output."""
    tmodel = tecd.PGNetV6(12)
    assert tmodel.stage0_width == tmodel.stage0.final_global.out_features
    assert tmodel.stage0_width == 128


@pytest.mark.parametrize("key,seed", [("pgnet_v8", 3), ("pgnet_v6", 4)])
def test_train_step_grads_match_jax(key, seed):
    over = dict(model=key, data_num_points=N, data_caps=CAPS,
                compute_dtype="float32")
    jcfg = js3dis(**over)
    jmodel = jbuild(jcfg)
    batch = next(toy.toy_batches(1, batch_size=1, num_points=N, seed=seed,
                                 kind="room", num_classes=13, feat_dim=12))
    b0 = [batch[k][0] for k in ("xyz", "feats", "mask")]
    params = random_params(jmodel, *b0, seed=seed)
    cw = np.asarray(jcfg.data.class_weights, np.float32)

    def loss_fn(p):
        logits = jmodel.apply(p, *b0, False)
        return jseg_loss(logits, batch["labels"][0], b0[2], cw, None)[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    flat = np.array(ravel_pytree(grads)[0])
    vec = ravel_pytree(params)[0]
    opt = optax.adam(jschedule(jcfg)).init(vec)
    trainer = Trainer(ts3dis(**over), device="cpu")
    state = trainer.init_state(state=flax_train_state_to_torch(
        JState(step=np.int32(0), params=params, opt_state=opt),
        trainer.model))
    tloss, tgrad = trainer.loss_and_grad(state, batch, train=False)
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-4)
    assert np.abs(flat).max() > 1e-2
    np.testing.assert_allclose(tgrad.numpy(), flat, rtol=1e-4, atol=1e-4)
    # the non-Dense leaves take gradients too
    for leaf in trainer.layout:
        if leaf.path[-1] in ("scale", "edge_weights_trans"):
            assert leaf.view(tgrad).abs().max() > 0, leaf.key
    state, m = trainer.train_step(state, batch)
    assert state.step == 1 and int(m["skipped"]) == 0
    assert np.isfinite(float(m["loss"]))
