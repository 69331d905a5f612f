"""The S3DIS ablations of the PointNet family against the JAX package,
float32, ``train=False``, converted weights (helpers in
``test_torch_archs.py``): ``pointnet_baseline20`` (20 plain-MLP noconcat
convs on gathered raw features), ``pointnet_concat10_deconv`` (the deconv
decoder and the unfactored head's ``class_mlp1``) and
``pointnet_embed_only`` (the flagship with every annulus collapsed)."""
import pytest

from pointcloudsegmentation_tpu_torch.models import layers as tl
from pointcloudsegmentation_tpu_torch.models.fast_conv import \
    PointNetConvFast
from test_torch_archs import end_to_end, layer_by_layer, make_case, \
    round_trip

KEYS = ("pointnet_baseline20", "pointnet_concat10_deconv",
        "pointnet_embed_only")


@pytest.fixture(scope="module")
def cases():
    return {}


def case(cases, key):
    if key not in cases:
        cases[key] = make_case("s3dis", key, 20 + KEYS.index(key))
    return cases[key]


def test_pointnet_concat10_deconv_layer_by_layer(cases):
    """The deconv decoder (``deconv1``, ``deconv0``: growth MLPs with the
    new columns last on [up ‖ stage feats ‖ dxyz]) and the unfactored
    head, whose ``class_mlp1`` maps the 1896-wide decoder output."""
    tmodel = layer_by_layer(case(cases, "pointnet_concat10_deconv"),
                            10 + 2 + 1 + 2)
    assert tmodel.encoder.head_dim is None
    assert not tmodel.head.premixed
    assert tmodel.head.class_mlp1.in_features == 1896
    assert not tmodel.encoder.deconv0.new_first


@pytest.mark.parametrize("key", KEYS)
def test_end_to_end(cases, key):
    end_to_end(case(cases, key))


@pytest.mark.parametrize("key", KEYS)
def test_convert_round_trip(cases, key):
    tmodel = round_trip(case(cases, key))
    enc = tmodel.encoder
    if key == "pointnet_baseline20":
        convs = [getattr(enc, f"feats{i}") for i in range(20)]
        assert all(isinstance(c, tl.PointNetConv) and not c.concat_growth
                   for c in convs)
        assert convs[0].fc_0.in_features == 2 * 12 + 3
    else:
        assert all(isinstance(getattr(enc, f"feats{i}"), PointNetConvFast)
                   for i in range(10 if key.endswith("deconv") else 13))
