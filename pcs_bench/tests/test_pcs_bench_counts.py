"""The frozen yardstick against the program as it stands: the operations
counted on the reference equal ``Trainer.step_flops``, and the windowed
gathers the count reads are the calls the port's kernel wrappers
receive."""
import collections

import numpy as np
import pytest
import torch

from pcs_bench import data, harness, program
from pcs_bench.counts import work
from pointcloudsegmentation_tpu_torch.data.provider import to_device
from pointcloudsegmentation_tpu_torch.kernels import window_gather as wg

from conftest import TINY_CAPS

CELLS = ["pointnet_s3dis.train_dense", "ecd_s3dis.train_dense"]


def _cell(bench, workload, points, caps):
    cell = harness.Cell(bench, workload)
    cell.config = dict(cell.config, caps=caps)
    cell.traffic = dict(cell.traffic, points_per_block=points,
                        blocks_per_step=2, batches=1)
    return cell


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("points,caps", [(1024, None), (2048, TINY_CAPS)])
def test_flops_equal_step_flops(bench, workload, points, caps):
    """At the cells' caps (or smaller ones), blocks of 1,024 or 2,048
    points: the reference's count of a training block times the blocks is
    the port's ``step_flops`` of the step."""
    cell = _cell(bench, workload, points, caps or
                 harness.Cell(bench, workload).config["caps"])
    trainer, _, flat = program.build(cell.config, 7, "cpu")
    state = program.fresh_state(flat)
    batch = data.train_batches(cell.config, cell.traffic, 7)[0]
    ours = work.block_work(cell.config, points, True, "cpu")["flops"]
    assert ours * 2 == trainer.step_flops(state, batch)


def _port_calls(cell, train):
    """The (n, k, f, element bytes, window, tile) of every K2 and K3 call
    the port's wrappers receive in one block's training step, or its
    forward."""
    calls = collections.defaultdict(list)
    real_g, real_d = wg._gather, wg._dslab

    def gather(feats, lidx, window, tile):
        calls["k2"].append((feats.shape[0], lidx.shape[1], feats.shape[1],
                            feats.element_size(), window, tile))
        return real_g(feats, lidx, window, tile)

    def dslab(g, lidx, window, tile):
        calls["k3"].append((g.shape[0], g.shape[1], g.shape[2],
                            g.element_size(), window, tile))
        return real_d(g, lidx, window, tile)

    trainer, _, flat = program.build(cell.config, 7, "cpu")
    state = program.fresh_state(flat)
    batch = to_device(data.train_batches(cell.config, cell.traffic, 7)[0],
                      "cpu")
    wg._gather, wg._dslab = gather, dslab
    try:
        if train:
            trainer.train_step(state, {k: v[:1] for k, v in batch.items()})
        else:
            with torch.no_grad():
                trainer.bind(state)(batch["xyz"][0], batch["feats"][0],
                                    batch["mask"][0])
    finally:
        wg._gather, wg._dslab = real_g, real_d
    return calls


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("train", [True, False])
def test_gather_calls_are_the_ports(bench, workload, train, monkeypatch):
    """The gathers the byte count reads (recorded on the reference) are the
    K2 calls of the port, and those whose features take a gradient its K3
    calls, shape for shape and in order."""
    cell = _cell(bench, workload, 1024, TINY_CAPS)
    seen = {}
    real = work.gather_bytes

    def keep(calls, train_):
        seen["calls"] = list(calls)
        return real(calls, train_)

    monkeypatch.setattr(work, "gather_bytes", keep)
    work.block_work(cell.config, 1024, train, "cpu")
    ref = seen["calls"]
    port = _port_calls(cell, train)
    assert [c[:6] for c in ref] == port["k2"]
    k3 = [c[:6] for c in ref if c[6]] if train else []
    assert sorted(k3) == sorted(port["k3"])
    assert len(port["k2"]) > 0


def test_gather_bytes_closed_form():
    """One K2 call of N=512, K=8, F=4 bf16 (window 256, tile 256) and its
    K3: every input byte read once, every output byte written once."""
    n, k, f, es, w, t = 512, 8, 4, 2, 256, 256
    k2 = n * f * es + n * k * 4 + n * k * f * es
    nt, s = n // t, t + 2 * w
    maps = nt * (s + 1) * 4 + nt * t * k * 4
    k3 = (n * k * 4 + maps) + (n * k * f * es + maps + nt * s * f * es)
    assert work.gather_bytes([(n, k, f, es, w, t, True)], False) == k2
    assert work.gather_bytes([(n, k, f, es, w, t, True)], True) == k2 + k3
    assert np.isclose(work.gather_bytes([(n, k, f, es, w, t, False)], True),
                      k2)
