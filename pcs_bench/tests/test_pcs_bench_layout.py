"""The yardstick's parameter layout and initial weights against the port's
models: ``reference.model.layout`` of the model of every registry key the
port's ``_ARCHS`` and ``_ENCODERS`` hold, but the trainable-anchor
template, is the port's ``ravel_layout`` (the ``Trainer``'s layout) key for
key, shape for shape and offset for offset; ``glorot_flat`` starts each
leaf as the port's Glorot initialisation does; and the flat vectors of the
benchmarked configurations are bitwise what they were before the layout
took leaf kinds beyond weights and biases."""
import hashlib

import pytest
import torch

from pcs_bench import harness, program, weights
from pcs_bench.reference import model as ref_model
from pointcloudsegmentation_tpu_torch.config import TrainConfig
from pointcloudsegmentation_tpu_torch.convert import (ravel_layout,
                                                      ravel_params)
from pointcloudsegmentation_tpu_torch.train import model_zoo

# ``template_anchor``'s trainable anchors start at the sphere k-means, not
# at a draw or a constant the benchmark makes
KEYS = sorted(k for k in {**model_zoo._ARCHS, **model_zoo._ENCODERS}
              if k != "template_anchor")
SEED = 2 ** 31 + 3
# sha256 of the float32 bytes of ``glorot_flat`` on the CPU, recorded at
# commit f603e69d5656d7efaaac8f3957033c1ecc6d7d01
DIGESTS = {
    ("pointnet_s3dis", 0):
        "9d587fdd81989aaff697d612b2d858d328fc6a78b958fa3b213fe2b468c66e2f",
    ("pointnet_s3dis", 2147483659):
        "8a056235c36dc03e3cac96e7dd5b27b9b079923b1e8b6c0ac27e8986e4d7cdf6",
    ("ecd_s3dis", 0):
        "669495736a9bd952edbcde540551fc0d1c2955b73c712904b0f752fd2c2865cb",
    ("ecd_s3dis", 2147483659):
        "1770c044de4d2b886810ea851f34c07893032be2f569030bbee3cffc4dc2e42d",
}


def _port_model(key, generator=None):
    return model_zoo.build_model(TrainConfig(model=key), generator,
                                 device="cpu")


@pytest.mark.parametrize("key", KEYS)
def test_layout_and_weights_are_the_ports(key):
    """The layout equals the port's; each drawn leaf (a kernel, a ``pw``)
    lies within its Glorot limit with both signs, as the port's own draw
    does and nearly reaches; each constant leaf (a bias, an
    ``edge_weights_trans``, a batch norm's ``scale``) is the port's."""
    port = _port_model(key, torch.Generator().manual_seed(SEED))
    leaves = ref_model.layout(port)
    theirs = ravel_layout(port)
    assert [(lf.key, lf.shape, lf.offset) for lf in leaves] == [
        (lf.key, lf.shape, lf.offset) for lf in theirs]
    ours = weights.glorot_flat(leaves, SEED, "cpu")
    port_flat = ravel_params(port, theirs)
    assert ours.shape == port_flat.shape
    kinds = set()
    for lf in leaves:
        a = ours[lf.offset:lf.offset + lf.size]
        b = port_flat[lf.offset:lf.offset + lf.size]
        kinds.add(lf.key.rsplit(".", 1)[-1])
        if lf.limit == 0.0:
            assert torch.equal(a, torch.full_like(a, lf.const)), lf.key
            assert torch.equal(a, b), lf.key
            continue
        assert float(a.abs().max()) <= lf.limit, lf.key
        assert float(b.abs().max()) <= lf.limit * (1 + 1e-6), lf.key
        if lf.size >= 16:
            assert float(a.min()) < 0.0 < float(a.max()), lf.key
            assert float(b.abs().max()) > 0.5 * lf.limit, lf.key
    assert {"weight", "bias"} <= kinds <= set(ref_model.LEAF_KINDS)


def test_a_trainable_anchor_raises_naming_the_leaf():
    with pytest.raises(KeyError, match="xyz_gc_anchor"):
        ref_model.layout(_port_model("template_anchor"))


@pytest.mark.parametrize("config,seed", sorted(DIGESTS))
def test_benchmarked_weights_are_bitwise_unchanged(bench, config, seed):
    entry = {c["name"]: c for c in bench["configs"]}[config]
    cfg = harness.load_json(f"{harness.ROOT}/{entry['file']}")
    flat = weights.glorot_flat(program.reference_leaves(cfg), seed, "cpu")
    assert flat.dtype == torch.float32
    assert hashlib.sha256(flat.numpy().tobytes()).hexdigest() == DIGESTS[
        (config, seed)]
