"""The port's four profiler spans (``utils.profiling.span``): where a
training step and a labelling sweep open them and how they nest, that
with no profiler a span is one shared null context, and that a step
computes the same bits with the profiler on and off."""
import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pointcloudsegmentation_tpu_torch.config import s3dis_config
from pointcloudsegmentation_tpu_torch.data import toy
from pointcloudsegmentation_tpu_torch.eval.interpolate import \
    eval_scene_probs
from pointcloudsegmentation_tpu_torch.train.loop import Trainer
from pointcloudsegmentation_tpu_torch.utils import profiling

torch.set_num_threads(1)

N, BLOCKS = 512, 2
SPANS = ("pcs.forward", "pcs.encoder", "pcs.search", "pcs.backward")
# model -> (searches a block, encoder settings): tiny_s3dis has two
# stages, ECD's S3DIS net three, one search each
MODELS = {"tiny_s3dis": (2, dict(win_tile=64, win_window=64)),
          "ecd_s3dis": (3, {})}


def _trainer(model):
    cfg = s3dis_config(model=model, data_num_points=N, data_caps=(256, 64),
                       optim_epoch_steps=10, compute_dtype="float32")
    return Trainer(cfg, device="cpu", search_chunk=256, **MODELS[model][1])


def _batch():
    return next(toy.toy_batches(1, batch_size=BLOCKS, num_points=N,
                                kind="room"))


def _spans(prof):
    """The profiled ``pcs.*`` spans as (name, start, end, thread), in
    order of start."""
    out = [(e.name, e.time_range.start, e.time_range.end, e.thread)
           for e in prof.events() if e.name in SPANS]
    return sorted(out, key=lambda s: s[1])


def _parent(span, spans):
    """The innermost other span of the same thread around ``span``."""
    around = [s for s in spans if s is not span and s[3] == span[3]
              and s[1] <= span[1] and span[2] <= s[2]]
    return max(around, key=lambda s: s[1])[0] if around else None


def _check_nesting(spans, searches, backward):
    names = [s[0] for s in spans]
    assert names.count("pcs.forward") == BLOCKS
    assert names.count("pcs.backward") == (BLOCKS if backward else 0)
    assert names.count("pcs.encoder") == BLOCKS
    assert names.count("pcs.search") == BLOCKS * searches
    want = {"pcs.forward": None, "pcs.backward": None,
            "pcs.encoder": "pcs.forward", "pcs.search": "pcs.encoder"}
    for s in spans:
        assert _parent(s, spans) == want[s[0]], s


def test_span_without_a_profiler_is_the_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    a, b = profiling.span("pcs.forward"), profiling.span("pcs.search")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("pcs.forward"):
            torch.ones(4).sum()
    assert [e.name for e in prof.events()
            if e.name == "pcs.forward"] == ["pcs.forward"]
    assert profiling.span("pcs.forward") is a


@pytest.mark.parametrize("model", sorted(MODELS))
def test_train_step_opens_the_spans_once_a_block(model):
    """A step's blocks each open one forward and one backward; the encoder
    nests in the forward, each stage's search in the encoder."""
    trainer = _trainer(model)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_step(state, _batch())
    _check_nesting(_spans(prof), MODELS[model][0], backward=True)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_scene_sweep_opens_a_forward_a_block(model):
    """Labelling opens one forward a block (model and softmax) and no
    backward."""
    trainer = _trainer(model)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    net = trainer.bind(state)
    b = _batch()
    blocks = [{k: b[k][i] for k in ("xyz", "feats", "mask")}
              for i in range(BLOCKS)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, probs = eval_scene_probs(net, blocks)
    assert np.isfinite(probs).all()
    _check_nesting(_spans(prof), MODELS[model][0], backward=False)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_step_is_the_same_with_the_profiler_on_and_off(model):
    """The spans change nothing a step computes: its new state and metrics
    are bitwise equal with and without a profiler."""
    trainer = _trainer(model)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    batch = _batch()
    off, m_off = trainer.train_step(state, batch)
    with profile(activities=[ProfilerActivity.CPU]):
        on, m_on = trainer.train_step(state, batch)
    assert on.step == off.step
    for f in ("params", "mu", "nu", "count"):
        assert torch.equal(getattr(on, f), getattr(off, f)), f
    assert m_on.keys() == m_off.keys()
    for k in m_off:
        assert torch.equal(m_on[k], m_off[k]), k
