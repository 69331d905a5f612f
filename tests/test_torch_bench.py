"""The port's flagship bench (``pointcloudsegmentation_tpu_torch.bench``)
against the repo-root ``bench.py``: its eval scene bit for bit, its final
line's keys; ``Trainer.step_flops`` (a closed form for one conv, the batch
scaling, no side effects); ``Neighborhood.k`` / ``WindowedNeighborhood.k``
against JAX's on the flagship's level-0 neighborhoods."""
import ast
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from pointcloudsegmentation_tpu.data import toy as jtoy
from pointcloudsegmentation_tpu.ops import morton as jmorton
from pointcloudsegmentation_tpu.ops import search as jsearch
from pointcloudsegmentation_tpu.train import config as jconfig
from pointcloudsegmentation_tpu.train import model_zoo as jzoo
from pointcloudsegmentation_tpu_torch import bench
from pointcloudsegmentation_tpu_torch.config import s3dis_config
from pointcloudsegmentation_tpu_torch.data import toy
from pointcloudsegmentation_tpu_torch.models.fast_conv import \
    PointNetConvFast
from pointcloudsegmentation_tpu_torch.models.layers import init_glorot_
from pointcloudsegmentation_tpu_torch.ops import search as tsearch
from pointcloudsegmentation_tpu_torch.ops.types import (Neighborhood,
                                                        WindowedNeighborhood)
from pointcloudsegmentation_tpu_torch.train.loop import Trainer
from pointcloudsegmentation_tpu_torch.train.model_zoo import build_model

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(model="tiny_s3dis", data_num_points=512, data_caps=(256, 64),
            compute_dtype="float32")
TILE = dict(win_tile=64, win_window=64, search_chunk=256)


def _jax_bench_scene(num_points):
    """The repo-root ``bench.py``'s eval scene (its lines 107-129), built as
    it builds it: the JAX package's room blocks through device arrays."""
    rng = np.random.RandomState(0)
    blocks = []
    for i in range(8):
        blk = jtoy.synthetic_room_block(rng, n=num_points, num_classes=13,
                                        feat_dim=12)
        blocks.append({"xyz": jnp.asarray(blk["xyz"]),
                       "feats": jnp.asarray(blk["feats"]),
                       "mask": jnp.asarray(np.ones(num_points, bool)),
                       "block_min": np.array([3.0 * i, 0, 0], np.float32)})
    dense = np.concatenate(
        [np.repeat(np.asarray(b["xyz"]), 4, axis=0)
         + rng.uniform(-0.05, 0.05, (4 * num_points, 3)).astype(np.float32)
         + b["block_min"][None, :]
         for b in blocks], axis=0).astype(np.float32)
    return blocks, dense


def test_eval_scene_is_the_jax_bench_scene():
    want_blocks, want_dense = _jax_bench_scene(512)
    blocks, dense = bench.eval_scene(512, np.random.RandomState(0))
    assert len(blocks) == len(want_blocks) == 8
    for b, w in zip(blocks, want_blocks):
        assert b.keys() == w.keys()
        for k in w:
            got, ref = np.asarray(b[k]), np.asarray(w[k])
            assert got.dtype == ref.dtype, k
            np.testing.assert_array_equal(got, ref)
    assert dense.dtype == want_dense.dtype and dense.shape == (8 * 4 * 512, 3)
    np.testing.assert_array_equal(dense, want_dense)


def _jax_bench_keys():
    """The keys of the dict that the repo-root ``bench.py`` prints last,
    read from its source without running it."""
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    dumps = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Attribute) and n.func.attr == "dumps"]
    last = max(dumps, key=lambda n: n.lineno)
    return [k.value for k in last.args[0].keys]


def test_main_prints_the_jax_bench_keys(monkeypatch, capsys):
    # a peak for the CPU, which the table does not hold; caps cut to the
    # 1024-point blocks (bench.py's level-1 cap of 4096 is 4x such a block
    # and takes minutes of CPU); 1 warm-up step and chains of 2
    monkeypatch.setattr(bench, "peak_flops", lambda device: 1e12)
    monkeypatch.setattr(bench, "CAPS", (512, 128))
    monkeypatch.setattr(bench, "WARMUP", 1)
    monkeypatch.setattr(bench, "ITERS", 2)
    out = bench.main(["--device", "cpu", "--points", "1024", "--batch", "2"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == out
    assert list(out) == _jax_bench_keys()
    assert out["metric"] == "s3dis_train_points_per_sec_per_chip"
    assert out["unit"] == "points/s"
    for k in ("value", "vs_baseline", "mfu", "flops_per_step",
              "eval_points_per_sec_per_chip"):
        assert np.isfinite(out[k]) and out[k] > 0, (k, out[k])
    assert out["mfu"] == float(f"{out['mfu']:.4g}")


@pytest.mark.parametrize("name,peak", [("NVIDIA H100 80GB HBM3", 989e12),
                                       ("NVIDIA A100-SXM4-80GB", None)])
def test_peak_flops_by_device_name(name, peak, monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device: name)
    if peak is None:
        with pytest.raises(KeyError, match="no peak FLOP/s"):
            bench.peak_flops(torch.device("cuda"))
    else:
        assert bench.peak_flops(torch.device("cuda")) == peak


@pytest.mark.parametrize("windowed", [False, True])
def test_step_flops_of_one_conv_is_the_closed_form(windowed):
    """One ``PointNetConvFast``'s forward: each layer's centre and neighbour
    projections of the F input columns per point, its sxyz projection and
    the earlier layers' hidden projections per slot, 2 operations a
    multiply-add."""
    n, f, dims = 1024, 12, (8, 8, 16)
    rng = np.random.RandomState(0)
    xyz = toy.synthetic_room_block(rng, n=n)["xyz"]
    x, m, _ = jmorton.sort_block(xyz, np.ones(n, bool), 0.0375, 3.0)
    xt, mt = torch.from_numpy(np.array(x)), torch.from_numpy(np.array(m))
    if windowed:
        ((nbr, sxyz),) = tsearch.windowed_multi_band_neighbors(
            xt, mt, ((0.0, 0.3, 16),), tile=256, window=256, cand_k=32,
            ov_slots=8, chunk=1024, ov_pool_size=256, return_sxyz=True,
            sel_mode="slab")
        assert isinstance(nbr, WindowedNeighborhood)
    else:
        ((nbr, sxyz),) = tsearch.multi_band_neighbors(
            xt, mt, ((0.0, 0.3, 16),), cand_k=16, chunk=1024,
            return_sxyz=True)
        assert isinstance(nbr, Neighborhood)
    k = nbr.k
    conv = PointNetConvFast(f, dims[:-1], dims[-1])
    init_glorot_(conv, torch.Generator().manual_seed(0))
    feats = torch.randn(n, f, generator=torch.Generator().manual_seed(1))
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        out = conv(sxyz, feats, nbr)
    assert out.shape == (n, dims[-1])
    want = sum(2 * n * f * d * 2 + 2 * n * k * 3 * d
               + sum(2 * n * k * dj * d for dj in dims[:i])
               for i, d in enumerate(dims))
    assert counter.get_total_flops() == want


def _tiny_batch(blocks):
    return next(toy.toy_batches(1, batch_size=blocks, num_points=512,
                                kind="room"))


def test_step_flops_scales_with_the_blocks():
    tr = Trainer(s3dis_config(**TINY), device="cpu", **TILE)
    state = tr.init_state(torch.Generator().manual_seed(0))
    batch = _tiny_batch(2)
    one = tr.step_flops(state, {k: v[:1] for k, v in batch.items()})
    two = tr.step_flops(state, batch)
    assert one > 0 and two == 2 * one
    # the count holds the backward: more than the training forward alone
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        tr.bind(state)(torch.from_numpy(batch["xyz"][0]),
                       torch.from_numpy(batch["feats"][0]),
                       torch.from_numpy(batch["mask"][0]), train=True,
                       generator=tr._dropout_generator(0, 0))
    assert 2 * counter.get_total_flops() < one


def test_step_flops_leaves_the_state_and_the_next_step_alone():
    cfg = s3dis_config(**TINY)
    batch = _tiny_batch(2)
    tr = Trainer(cfg, device="cpu", **TILE)
    state = tr.init_state(torch.Generator().manual_seed(0))
    state, _ = tr.train_step(state, batch)     # moments and count non-zero
    before = {f: getattr(state, f).clone()
              for f in ("params", "mu", "nu", "count")}
    tr.step_flops(state, batch)
    assert state.step == 1
    for f, v in before.items():
        assert torch.equal(getattr(state, f), v), f
    counted, m_counted = tr.train_step(state, batch)
    fresh = Trainer(cfg, device="cpu", **TILE)
    plain, m_plain = fresh.train_step(state, batch)
    assert counted.step == plain.step
    for f in ("params", "mu", "nu", "count"):
        assert torch.equal(getattr(counted, f), getattr(plain, f)), f
    assert torch.equal(m_counted["loss"], m_plain["loss"])


def test_neighborhood_k_matches_jax_on_the_flagship_level0():
    """Both neighborhood types of the flagship's level 0 (a 1024-point
    block: windowed at the flagship's settings, and the global search),
    from both packages."""
    n = 1024
    cfg = s3dis_config(data_num_points=n, data_caps=(512, 128))
    enc = build_model(cfg, None, "cpu").encoder
    xyz = toy.synthetic_room_block(np.random.RandomState(0), n=n)["xyz"]
    x, m, _ = jmorton.sort_block(xyz, np.ones(n, bool),
                                 cfg.data.voxel_sizes[0] / 4,
                                 cfg.data.block_size)
    x, m = np.array(x), np.array(m)
    specs = list(dict.fromkeys(enc.stage_specs(0)))
    bands = tuple((mn, mx, k) for (mx, mn, k) in specs)
    port = enc._stage_neighborhoods(torch.from_numpy(x), torch.from_numpy(m),
                                    specs, True)
    jwin = jsearch.windowed_multi_band_neighbors(
        x, m, bands, tile=enc.win_tile, window=enc.win_window,
        cand_k=jsearch.effective_win_cand_k(enc.win_cand_k, enc.cand_k,
                                            bands, n),
        ov_slots=enc.ov_slots, chunk=enc.search_chunk,
        ov_pool_size=enc.ov_pool_size, return_sxyz=True, sel_mode="slab")
    jglob = jsearch.multi_band_neighbors(x, m, bands, cand_k=enc.cand_k,
                                         chunk=enc.search_chunk)
    tglob = tsearch.multi_band_neighbors(
        torch.from_numpy(x), torch.from_numpy(m), bands, cand_k=enc.cand_k,
        chunk=enc.search_chunk)
    for spec, (jw, _), jg, tg in zip(specs, jwin, jglob, tglob):
        tw = port[spec][0]
        assert isinstance(tw, WindowedNeighborhood)
        assert tw.k == jw.k == spec[2] + enc.ov_slots
        assert tw.to_neighborhood().k == jw.to_neighborhood().k == tw.k
        assert tg.k == jg.k == spec[2]
        assert tw.k == tw.mask.shape[-1] and tg.k == tg.idx.shape[-1]


def test_flagship_bench_config_is_the_jax_bench_config():
    """The train config of ``bench.py:38-40`` (caps and features), built by
    both packages: the same model, dtype and data fields, and the same
    parameter count (JAX's by ``jax.eval_shape``), the flagship's
    1,765,097."""
    kw = dict(data_num_points=8192, data_caps=bench.CAPS,
              data_feat_dim=bench.FEAT_DIM)
    jcfg, cfg = jconfig.s3dis_config(**kw), s3dis_config(**kw)
    assert cfg.model == jcfg.model == "pointnet_s3dis"
    assert cfg.compute_dtype == jcfg.compute_dtype == "bfloat16"
    assert dataclasses.asdict(cfg.data) == dataclasses.asdict(jcfg.data)
    assert tuple(cfg.data.caps) == (4096, 1024)
    n = cfg.data.num_points
    shapes = jax.eval_shape(lambda: jzoo.build_model(jcfg).init(
        jax.random.PRNGKey(0), np.zeros((n, 3), np.float32),
        np.zeros((n, bench.FEAT_DIM), np.float32), np.ones(n, bool),
        False))
    jn = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    model = build_model(cfg, None, "cpu")
    assert sum(p.numel() for p in model.parameters()) == jn == 1_765_097
