"""The plain reference: it imports nothing of the program, the program in
float32 agrees with it at a small size, and the lower-precision control in
the program's place fails the cell's limits (the control of ``correct``,
at a size a test run holds; on the card it is read at the cells' own size
by ``python3 -m pcs_bench.calibrate``)."""
import ast
import glob
import os

import pytest

from pcs_bench import calibrate, compare, harness

from conftest import tiny_cell

REF = os.path.join(harness.HERE, "reference")
TRAIN = ["pointnet_s3dis.train_dense", "ecd_s3dis.train_dense"]
LABEL = ["pointnet_s3dis.label_dense", "ecd_s3dis.label_dense"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield ("." * node.level) + (node.module or "")


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REF,
                                                               "*.py"))))
def test_reference_imports_nothing_of_the_program(path):
    for name in _imports(path):
        top = name.lstrip(".").split(".")[0]
        assert top not in ("pointcloudsegmentation_tpu_torch",
                           "pointcloudsegmentation_tpu", "jax", "flax",
                           "pcs_bench"), (path, name)
        # relative imports stay inside the reference
        assert not name.startswith(".."), (path, name)


@pytest.mark.parametrize("workload", TRAIN + LABEL)
def test_float32_program_agrees_and_the_control_fails(bench, workload):
    """At 1,024 points a block: the program computing in float32 reads
    within every limit of the cell (bit-equal pyramid and neighbours, logits
    and losses to rounding); the float8 control reads beyond at least one
    of them."""
    cell = tiny_cell(bench, workload, "float32")
    out = calibrate.read_seed(cell, 2 ** 31 + 5, "cpu", control=True,
                              fault=False, units=1)
    ok, checks = compare.judge(out["program"], cell.limits)
    assert ok, checks
    if workload in TRAIN:
        assert out["program"]["pyramid_mismatch"] == 0
        assert out["program"]["neighbour_mismatch"] == 0
        assert out["program"]["logit_gap"] < 1e-5
        assert out["program"]["loss_gap"] < 1e-3
    else:
        assert out["program"]["prob_gap_max"] < 1e-4
    ok, checks = compare.judge(out["control"], cell.limits)
    assert not ok, checks
