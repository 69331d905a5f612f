"""The port's component times (``pointcloudsegmentation_tpu_torch.
model_breakdown``) against ``scripts/model_breakdown.py`` at 1024 points:
``sorted_cloud`` against the JAX script's own function, and every timed op,
run once on the port's inputs (JAX weights carried over by
``convert.load_flax_params``), against the JAX call the script times: the
search's neighbor sets (through ``to_neighborhood``) exactly, the conv
forward and its gradient in the features, windowed and plain, within 1e-5
of max(1, the largest |JAX value|) in float32, the Morton sort and inverse
and the pyramid exactly, and ``tiny_s3dis``'s forward within 1e-5 of
scale; the row labels are the script's f-strings."""
import dataclasses
import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudsegmentation_tpu.models import fast_conv as jfc
from pointcloudsegmentation_tpu.models import layers as jl
from pointcloudsegmentation_tpu.ops import hierarchy as jhier
from pointcloudsegmentation_tpu.ops import morton as jmorton
from pointcloudsegmentation_tpu.ops import search as jsearch
from pointcloudsegmentation_tpu.train import config as jconfig
from pointcloudsegmentation_tpu.train.model_zoo import build_model as jbuild
from pointcloudsegmentation_tpu_torch import microbench as mb
from pointcloudsegmentation_tpu_torch import model_breakdown as mbd
from pointcloudsegmentation_tpu_torch.convert import load_flax_params
from pointcloudsegmentation_tpu_torch.models.fast_conv import \
    PointNetConvFast
from test_torch_model import random_params

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 1024
ZERO = torch.zeros(())


def _jax_script():
    """``scripts/model_breakdown.py`` (and the ``microbench`` it imports)
    as modules, the environment left as it was."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    saved = dict(os.environ)
    try:
        return importlib.import_module("model_breakdown")
    finally:
        sys.path.remove(os.path.join(ROOT, "scripts"))
        os.environ.clear()
        os.environ.update(saved)


def _np(t):
    return t.detach().numpy()


def close(got, want, tol=1e-5):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32) / scale,
                               want / scale, atol=tol, rtol=0)


def test_sorted_cloud_is_the_jax_scripts():
    xs, ms = _jax_script().sorted_cloud(N)
    txs, tms = mbd.sorted_cloud(N, "cpu")
    np.testing.assert_array_equal(_np(txs), np.asarray(xs))
    np.testing.assert_array_equal(_np(tms), np.asarray(ms))


@pytest.fixture(scope="module")
def conv_case():
    """The conv rows on the port's search, with the weights of the JAX
    script's ``PointNetConvFast((8, 8, 16), 32)`` (float32), and the JAX
    search of the same cloud."""
    jl.set_compute_dtype(None)
    conv = PointNetConvFast(64, (8, 8, 16), 32)
    cases = mbd.conv_cases(False, "cpu", n=N, conv=conv)
    io = cases[0].inputs
    xs, ms = jnp.asarray(_np(io["xs"])), jnp.asarray(_np(io["ms"]))
    ((jw, jsx),) = jsearch.windowed_multi_band_neighbors(
        xs, ms, ((0.0, 0.15, 32),), cand_k=64, ov_slots=12,
        return_sxyz=True, chunk=2048)
    feats = jnp.asarray(_np(io["feats"]))
    jconv = jfc.PointNetConvFast((8, 8, 16), 32)
    params = jax.jit(jconv.init)(jax.random.PRNGKey(0), jsx, feats, jw)
    load_flax_params(conv, params)
    return cases, jw, jsx, jconv, params, feats


def test_conv_search_is_the_jax_search(conv_case):
    cases, jw, jsx, *_ = conv_case
    io = cases[0].inputs
    for got, want in ((io["windowed"].to_neighborhood(),
                       jw.to_neighborhood()), (io["plain"],
                                               jw.to_neighborhood())):
        np.testing.assert_array_equal(_np(got.idx), np.asarray(want.idx))
        np.testing.assert_array_equal(_np(got.mask), np.asarray(want.mask))
    np.testing.assert_allclose(_np(io["sxyz"]), np.asarray(jsx), atol=1e-6)


def test_conv_ops(conv_case):
    """Forward and the gradient in the features of the sum of the
    output, windowed and plain (``scripts/model_breakdown.py:58-71``)."""
    cases, jw, jsx, jconv, params, feats = conv_case
    k = jw.k
    assert [c.label for c in cases] == [
        f" conv fwd      [{lb}] N={N} K+Ko={k}" if i == 0 else
        f" conv fwd+bwd  [{lb}] N={N} K+Ko={k}"
        for lb in ("windowed", "plain") for i in (0, 1)]
    for (fwd, fb), nbr in zip((cases[:2], cases[2:]),
                              (jw, jw.to_neighborhood())):
        def apply(f, nbr=nbr):
            return jnp.sum(jconv.apply(params, jsx, f, nbr).astype(
                jnp.float32))

        close(_np(fwd.fn(ZERO)), jconv.apply(params, jsx, feats, nbr))
        close(_np(fb.fn(ZERO)), jax.grad(apply)(feats))


def test_search_ops():
    """Both searches' neighbor sets and geometry, band by band
    (``scripts/model_breakdown.py:79-97``)."""
    cases = mbd.search_cases("cpu", n=N)
    assert [c.label for c in cases] == [
        f" windowed_multi_band rt=1 (exact) 4 bands N={N}",
        f" global multi_band (production) 4 bands N={N}"]
    io = cases[0].inputs
    xs, ms = jnp.asarray(_np(io["xs"])), jnp.asarray(_np(io["ms"]))
    want_w = jsearch.windowed_multi_band_neighbors(
        xs, ms, mbd.BANDS, cand_k=64, ov_slots=12, chunk=2048,
        recall_target=0.95, return_sxyz=True)
    want_g = jsearch.multi_band_neighbors(xs, ms, mbd.BANDS, cand_k=64,
                                          chunk=2048, return_sxyz=True)
    got_w, got_g = cases[0].fn(ZERO), cases[1].fn(ZERO)
    assert len(got_w) == len(got_g) == len(mbd.BANDS)
    for (tw, tsx), (jw, jsx) in zip(got_w, want_w):
        tn, jn = tw.to_neighborhood(), jw.to_neighborhood()
        np.testing.assert_array_equal(_np(tn.idx), np.asarray(jn.idx))
        np.testing.assert_array_equal(_np(tn.mask), np.asarray(jn.mask))
        np.testing.assert_allclose(_np(tsx), np.asarray(jsx), atol=1e-6)
    for (tn, tsx), (jn, jsx) in zip(got_g, want_g):
        np.testing.assert_array_equal(_np(tn.idx), np.asarray(jn.idx))
        np.testing.assert_array_equal(_np(tn.mask), np.asarray(jn.mask))
        np.testing.assert_allclose(_np(tsx), np.asarray(jsx), atol=1e-6)


def test_sort_op():
    """``scripts/model_breakdown.py:110-114``: the sorted cloud and
    features and the inverse permutation, exactly."""
    (case,) = mbd.sort_cases("cpu", n=N)
    assert case.label == f" morton sort+inv N={N}"
    io = case.inputs
    xs, _, order, fs = jmorton.sort_block(
        _np(io["xyz"]), _np(io["mask"]), 0.0375, 3.0, _np(io["feats"]))
    want = (xs, fs, jmorton.inverse_permutation(order))
    for got, w in zip(case.fn(ZERO), want):
        np.testing.assert_array_equal(_np(got), np.asarray(w))


def test_model_ops():
    """``tiny_s3dis`` at 1024 points (caps 256/64, float32) with JAX's
    weights: the pyramid of block 0 exactly and its forward
    (``scripts/model_breakdown.py:147-160``); the gradient row's leaves
    cover every parameter."""
    over = dict(model="tiny_s3dis", data_caps=(256, 64),
                compute_dtype="float32")
    trainer, state, batch = mbd.model_setup("cpu", n=N, **over)
    assert batch["xyz"].shape[0] == 4
    assert trainer._encoder_kw["search_chunk"] == 2048
    jcfg = jconfig.s3dis_config(data_num_points=N, data_feat_dim=12, **over)
    jmodel = jbuild(jcfg, search_chunk=2048)
    xyz, feats, mask = (_np(batch[k][0]) for k in ("xyz", "feats", "mask"))
    params = random_params(jmodel, xyz, feats, mask, seed=3)
    load_flax_params(trainer.model, params)
    state = dataclasses.replace(state, params=trainer._flat.clone())
    pyr, fwd, fwdbwd = mbd.model_cases(trainer, state, batch)
    assert [c.label for c in (pyr, fwd, fwdbwd)] == [
        " sort+pyramid (1 block)", " full model fwd (1 block)",
        " full model fwd+bwd wrt params (1 block)"]

    d = jcfg.data
    xs, ms, _ = jmorton.sort_block(xyz, mask, d.voxel_sizes[0] / 4,
                                   d.block_size)
    p = jhier.build_pyramid(xs, ms, d.voxel_sizes, d.caps, d.block_size)
    want = [lv.xyz for lv in p.levels] + list(p.seg)
    got = pyr.fn(ZERO)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))

    logits = jax.jit(lambda p: jmodel.apply(p, xyz, feats, mask, False))(
        params)
    close(_np(fwd.fn(ZERO)), logits)
    grads = fwdbwd.fn(ZERO)
    assert sum(g.numel() for g in grads) == trainer.num_params
    assert all(torch.isfinite(g).all() for g in grads)


def test_main_on_the_cpu(monkeypatch, capsys):
    """``--which sort --device cpu``: the baseline, then the row on the
    host clock with no device time."""
    monkeypatch.setattr(mb, "_BASELINE", mb._BASELINE)
    (row,) = mbd.main(["--which", "sort", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(" dispatch baseline: ")
    assert row.label == " morton sort+inv N=8192"
    assert out[1].startswith(row.label + ": ")
    assert np.isfinite(row.ms) and row.device_ms is None
