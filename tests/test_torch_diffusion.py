"""The probability-diffusion path of the port against the JAX package:
``search.radius_neighbors`` slot for slot (points on the radius boundary,
duplicates, padded points, an annulus, several query chunks),
``ProbsDiffusion`` on its neighborhood, ``tiny_s3dis`` with
``diffusion_steps=3`` end to end in float32 (``assert_close``: 1e-4 after
dividing by max(1, the largest |JAX output|)) and its loss and gradient,
the extra ``diffusion/alpha`` leaf through ``ravel_layout``, and the CLI's
``--use-diffusion``."""
import jax
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

from pointcloudsegmentation_tpu.data import toy
from pointcloudsegmentation_tpu.models import layers as jlayers
from pointcloudsegmentation_tpu.ops import search as jsearch
from pointcloudsegmentation_tpu.train import cli as jcli
from pointcloudsegmentation_tpu.train import config as jconfig
from pointcloudsegmentation_tpu.train import model_zoo as jzoo
from pointcloudsegmentation_tpu.train.loop import TrainState as JState
from pointcloudsegmentation_tpu.train.loop import \
    make_lr_schedule as jschedule
from pointcloudsegmentation_tpu.train.loop import seg_loss as jseg_loss
from pointcloudsegmentation_tpu_torch import config as tconfig
from pointcloudsegmentation_tpu_torch.convert import (
    flax_to_state_dict, flax_train_state_to_torch, load_flax_params,
    ravel_layout, ravel_params)
from pointcloudsegmentation_tpu_torch.eval.interpolate import \
    eval_scene_probs
from pointcloudsegmentation_tpu_torch.models import layers as tlayers
from pointcloudsegmentation_tpu_torch.ops import search as tsearch
from pointcloudsegmentation_tpu_torch.ops.types import Neighborhood
from pointcloudsegmentation_tpu_torch.train import cli
from pointcloudsegmentation_tpu_torch.train import model_zoo as tzoo
from pointcloudsegmentation_tpu_torch.train.loop import Trainer
from test_torch_archs import assert_close
from test_torch_model import random_params

torch.set_num_threads(1)
N = 1024


def _t(a):
    return torch.from_numpy(np.array(a))


def _block(seed, n=N, n_pad=0, lattice=False):
    """A toy room block (or, with ``lattice``, points on a 0.05 m grid, so
    that many pairs sit exactly on a 0.1 m radius) with ``n_pad`` padded
    points and a few exact duplicates."""
    rng = np.random.RandomState(seed)
    if lattice:
        g = np.stack(np.meshgrid(*[np.arange(11)] * 3, indexing="ij"), -1)
        xyz = (g.reshape(-1, 3)[:n] * 0.05).astype(np.float32)
    else:
        xyz = toy.synthetic_room_block(rng, n=n)["xyz"]
    xyz[n // 2:n // 2 + 5] = xyz[7]
    mask = np.ones(n, bool)
    if n_pad:
        mask[rng.choice(n, n_pad, replace=False)] = False
        xyz[~mask] = 0.0
    return xyz, mask


@pytest.mark.parametrize("seed,radius,min_radius,k,chunk,n_pad,lattice", [
    (0, 0.1, 0.0, 8, 1024, 0, False),      # the diffusion path's search
    (1, 0.1, 0.0, 8, 256, 40, False),      # chunked queries, padded points
    (2, 0.1, 0.0, 12, 1024, 0, True),      # pairs exactly on the radius
    (3, 0.2, 0.1, 12, 384, 17, False),     # an annulus, a ragged chunk
    (4, 0.1, 0.05, 8, 1024, 0, True),      # an annulus on the lattice
])
def test_radius_neighbors_matches_jax(seed, radius, min_radius, k, chunk,
                                      n_pad, lattice):
    xyz, mask = _block(seed, n_pad=n_pad, lattice=lattice)
    want = jsearch.radius_neighbors(xyz, mask, radius, k,
                                    min_radius=min_radius, chunk=chunk)
    got = tsearch.radius_neighbors(_t(xyz), _t(mask), radius, k,
                                   min_radius=min_radius, chunk=chunk)
    assert got.idx.dtype == torch.int32 and got.mask.dtype == torch.bool
    np.testing.assert_array_equal(got.mask.numpy(), np.array(want.mask))
    np.testing.assert_array_equal(got.idx.numpy(), np.array(want.idx))
    m = got.mask.numpy()
    assert m.any() and not m.all()
    row = np.arange(N)[:, None]
    # invalid slots hold the point's own index; padded points have none
    assert (got.idx.numpy()[~m] == np.broadcast_to(row, m.shape)[~m]).all()
    assert not m[~mask].any()
    if min_radius > 0:
        assert not (got.idx.numpy() == row)[m].any()
    if lattice:
        d = np.linalg.norm(xyz[got.idx.numpy()] - xyz[:, None], axis=-1)
        assert np.isclose(d[m], radius, rtol=1e-5).any()


def test_probs_diffusion_matches_jax():
    xyz, mask = _block(5, n_pad=30)
    jn = jsearch.radius_neighbors(xyz, mask, 0.1, 8)
    tn = Neighborhood(idx=_t(jn.idx), mask=_t(jn.mask))
    rng = np.random.RandomState(6)
    logits = rng.randn(N, 13).astype(np.float32)
    probs = np.array(jax.nn.softmax(logits, -1))
    jmod = jlayers.ProbsDiffusion(3)
    for alpha in (0.0, -1.3):
        params = {"params": {"alpha": np.full((1,), alpha, np.float32)}}
        want = np.array(jmod.apply(params, probs, jn))
        tmod = tlayers.ProbsDiffusion(3)
        tmod.load_state_dict(flax_to_state_dict(params), strict=True)
        with torch.no_grad():
            got = tmod(_t(probs), tn).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        # a valid point's rows still sum to 1 (a padded one has no
        # neighbor: its mean is 0, as in JAX)
        np.testing.assert_allclose(got[mask].sum(1), 1.0, atol=1e-5)
    assert not np.allclose(got, probs)


# -- tiny_s3dis with diffusion_steps=3 ----------------------------------------

def _cfgs(**over):
    over = dict(model="tiny_s3dis", data_num_points=N,
                data_caps=(1024, 256), diffusion_steps=3, **over)
    return (jconfig.s3dis_config(**over),
            tconfig.s3dis_config(compute_dtype="float32", **over))


@pytest.fixture(scope="module")
def case():
    """The JAX ``tiny_s3dis`` with 3 diffusion steps at 1024 points: random
    weights (``alpha`` among them), its logits, and the value and grad of
    its ``train=False`` loss."""
    jcfg, tcfg = _cfgs()
    jmodel = jzoo.build_model(jcfg)
    rng = np.random.RandomState(8)
    b = toy.synthetic_room_block(rng, n=N, num_classes=13, feat_dim=12)
    xyz, mask = b["xyz"].copy(), np.ones(N, bool)
    mask[rng.choice(N, 24, replace=False)] = False
    xyz[~mask] = 0.0
    params = random_params(jmodel, xyz, b["feats"], mask, seed=8)
    assert params["params"]["diffusion"]["alpha"].shape == (1,)
    logits = jax.jit(lambda p: jmodel.apply(p, xyz, b["feats"], mask,
                                            False))(params)
    cw = np.asarray(jcfg.data.class_weights, np.float32)

    def loss_fn(p):
        return jseg_loss(jmodel.apply(p, xyz, b["feats"], mask, False),
                         b["labels"], mask, cw, None)[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return dict(params=params, block=(xyz, b["feats"], mask),
                labels=b["labels"], logits=np.array(logits),
                loss=float(loss), grads=np.array(ravel_pytree(grads)[0]),
                jcfg=jcfg, cfg=tcfg)


def test_tiny_diffusion_end_to_end(case):
    """The port's logits (``log(max(p, 1e-12))`` of the smoothed
    probabilities, in the caller's point order) against JAX's."""
    tmodel = tzoo.build_model(case["cfg"], device="cpu")
    assert isinstance(tmodel.diffusion, tlayers.ProbsDiffusion)
    load_flax_params(tmodel, case["params"])
    with torch.no_grad():
        got = tmodel(*(_t(a) for a in case["block"])).numpy()
    assert got.shape == (N, 13) and np.isfinite(got).all()
    assert_close(got, case["logits"])
    # the smoothed probabilities still sum to 1 on every valid point
    mask = case["block"][2]
    np.testing.assert_allclose(np.exp(got[mask]).sum(1), 1.0, atol=1e-5)


def test_tiny_diffusion_loss_and_grads_match_jax(case):
    """The loss and every parameter's gradient, ``alpha``'s included,
    against ``jax.grad``, to 1e-4."""
    jcfg, tcfg = case["jcfg"], case["cfg"]
    opt = optax.adam(jschedule(jcfg)).init(ravel_pytree(case["params"])[0])
    trainer = Trainer(tcfg, device="cpu")
    state = trainer.init_state(state=flax_train_state_to_torch(
        JState(step=np.int32(0), params=case["params"], opt_state=opt),
        trainer.model))
    xyz, feats, mask = case["block"]
    batch = {"xyz": xyz[None], "feats": feats[None], "mask": mask[None],
             "labels": case["labels"][None]}
    loss, grad = trainer.loss_and_grad(state, batch, train=False)
    np.testing.assert_allclose(float(loss), case["loss"], rtol=1e-4)
    want = case["grads"]
    np.testing.assert_allclose(grad.numpy(), want, rtol=1e-4, atol=1e-4)
    alpha = next(leaf for leaf in trainer.layout if leaf.path[-1] == "alpha")
    assert alpha.path == ("diffusion", "alpha")
    assert abs(float(alpha.view(grad)[0])) > 1e-4


def test_alpha_starts_at_zero_and_counts_one_param():
    """A seeded build draws every Dense but leaves ``alpha`` at 0 (a mixing
    weight of 0.5, as the flax zeros init), and the diffusion key has the
    JAX model's 198,378 parameters: ``tiny_s3dis``'s and one more."""
    jcfg, tcfg = _cfgs()
    model = tzoo.build_model(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert float(model.diffusion.alpha.detach()) == 0.0
    n = sum(p.numel() for p in model.parameters())
    shapes = jax.eval_shape(lambda: jzoo.build_model(jcfg).init(
        jax.random.PRNGKey(0), np.zeros((N, 3), np.float32),
        np.zeros((N, 12), np.float32), np.ones(N, bool), False))
    jn = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert n == jn == 198378
    plain = tzoo.build_model(tconfig.s3dis_config(model="tiny_s3dis"), None,
                             "cpu")
    assert not hasattr(plain, "diffusion")
    assert n == sum(p.numel() for p in plain.parameters()) + 1


def test_alpha_leaf_loads_through_ravel_layout(case):
    """A JAX train state whose tree has ``diffusion/alpha`` loads: the flat
    layout is ``ravel_pytree``'s order and the Adam moments copy over."""
    params = case["params"]
    vec = ravel_pytree(params)[0]
    rng = np.random.RandomState(9)
    mu = rng.randn(vec.size).astype(np.float32)
    nu = rng.rand(vec.size).astype(np.float32)
    opt = optax.adam(jschedule(case["jcfg"])).init(vec)
    opt = (opt[0]._replace(count=np.int32(2), mu=mu, nu=nu),
           opt[1]._replace(count=np.int32(2)))
    model = tzoo.build_model(case["cfg"], device="cpu")
    layout = ravel_layout(model)
    assert [leaf.path for leaf in layout] == [
        tuple(k.key for k in p)[1:]
        for p, _ in jax.tree_util.tree_leaves_with_path(params)]
    st = flax_train_state_to_torch(
        JState(step=np.int32(2), params=params, opt_state=opt), model)
    np.testing.assert_array_equal(st.params.numpy(), np.array(vec))
    np.testing.assert_array_equal(st.mu.numpy(), mu)
    load_flax_params(model, params)
    np.testing.assert_array_equal(ravel_params(model, layout).numpy(),
                                  np.array(vec))


def test_eval_scene_probs_with_diffusion(case):
    """The scene sweep on a diffusion model gives rows that sum to 1."""
    tmodel = tzoo.build_model(case["cfg"], device="cpu")
    load_flax_params(tmodel, case["params"])
    xyz, feats, mask = case["block"]
    sxyz, probs = eval_scene_probs(tmodel, [dict(xyz=xyz, feats=feats,
                                                 mask=mask)])
    assert probs.shape == (int(mask.sum()), 13)
    np.testing.assert_allclose(probs.sum(1), 1.0, atol=1e-5)


@pytest.mark.parametrize("argv", [
    ["--config", "s3dis", "--use-diffusion", "3"],
    ["--config", "scannet", "--model", "tiny_s3dis", "--use-diffusion", "2"],
])
def test_cli_use_diffusion_matches_jax(argv):
    got = cli.build_cfg(cli.parse_args(argv))
    want = jcli.build_cfg(jcli.parse_args(argv))
    assert got.diffusion_steps == want.diffusion_steps == int(argv[-1])
    assert got.model == want.model


def test_cli_trains_with_use_diffusion(tmp_path):
    """One synthetic step of ``tiny_s3dis --use-diffusion 2`` on the CPU
    with its test epoch: a finite loss in the epoch record."""
    import json

    path = tmp_path / "m.jsonl"
    cli.main(["--config", "s3dis", "--synthetic", "--model", "tiny_s3dis",
              "--use-diffusion", "2", "--epochs", "1", "--steps-per-epoch",
              "1", "--batch-size", "1", "--num-points", "512", "--device",
              "cpu", "--metrics-file", str(path)])
    rec, = [json.loads(line) for line in open(path)]
    assert np.isfinite(rec["train_loss"]) and 0.0 <= rec["miou"] <= 1.0

