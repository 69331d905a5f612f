"""Fixtures of the benchmark's tests: a tiny copy of each cell that runs on
the CPU (the same files, with smaller blocks and caps), and the ``card``
marker for tests that need a CUDA device."""
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from pcs_bench import harness  # noqa: E402

# the port's CPU index accumulation is not repeatable across threads
torch.set_num_threads(1)

TINY_POINTS = 1024
TINY_CAPS = [1024, 256]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skipped without one")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided here, not
    while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.fixture(scope="session")
def bench():
    return harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))


def tiny_cell(bench, workload, compute_dtype=None):
    """The cell of ``workload`` at a size the CPU runs in seconds: blocks of
    1,024 points, caps (1024, 256), two blocks a step or a scene; with
    ``compute_dtype`` the model computes in it."""
    cell = harness.Cell(bench, workload)
    cell.config = dict(cell.config, caps=TINY_CAPS)
    if compute_dtype:
        cell.config["compute_dtype"] = compute_dtype
    cell.traffic = dict(cell.traffic, points_per_block=TINY_POINTS,
                        blocks_per_step=2, blocks_per_scene=2, trace_units=1)
    return cell
