"""Training loop (mirror of ``pointcloudsegmentation_tpu.train.loop`` on its
single-card gradient-accumulation path): class-weighted CE with
ignore-label masking, per-block forward + backward with the gradient
accumulated in float32, one flat Adam update with a non-finite guard, a
staircase LR schedule with a floor, streaming IoU.

Every parameter lives in one flat float32 vector in the JAX trainer's
``ravel_pytree`` order (``convert.ravel_layout``); the model's parameters
are views into it and their ``.grad``s views into a flat gradient buffer,
so backward accumulates straight into the flat gradient and Adam runs on
one vector.  A block's logits are per point [N, C] (segmentation), two
rows [2, N, C] (the refine cascade: refine, base) or one row [C] per
cloud (classification, as the JAX trainer's branch at
``train/loop.py:437-442``: the cloud's label is its first point's, and it
counts where any of its points is valid).  The cascade's loss is the
refine row's plus ``BASE_LOSS_WEIGHT`` times the base row's (JAX
``train/loop.py:443-455``); both rows share the labels and the mask, so
the weights are counted once, and the metrics come from the refine row.
A model with inputs beyond the block (the dense and context pipelines)
names the batch fields it takes after (xyz, feats, mask) in
``extra_keys``; each block passes them in that order, as the JAX
trainer's branches on ``dense_xyz`` / ``ctx_xyz`` do
(``train/loop.py:141-166, 193-214``).

Under a mesh of d ranks (``parallel.mesh``) every rank runs the same
per-block accumulation on its own blocks, then ONE ``all_reduce`` sums the
flat gradient, the loss terms and the metrics, as the single ``psum`` of
the JAX trainer's mesh step (``train/loop.py:347-378``); every rank then
applies the same update.  Each block's dropout stream derives from
(seed, step, global block index), as JAX splits one key per block, so
rank r's blocks draw what the single-card step's blocks r·B/d, ... draw.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, replace
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import TrainConfig
from ..convert import ravel_layout, ravel_params
from ..data.provider import device_prefetch, to_device
from ..parallel.mesh import Mesh, replicate
from ..utils import profiling
from . import metrics as metrics_lib
from .model_zoo import build_model

log = logging.getLogger(__name__)

# optax.adam defaults
B1, B2, EPS = 0.9, 0.999, 1e-8
# the refine cascade's base-row weight: the JAX trainer reads
# getattr(cfg, "base_loss_weight", 1.0) and its config has no such field
BASE_LOSS_WEIGHT = 1.0


@dataclass(frozen=True)
class TrainState:
    """step: optimizer steps taken (bad steps included, as in JAX);
    params, mu, nu: flat float32 [P] in ravel order; count: the Adam and
    schedule count (int32 scalar tensor), which a skipped step leaves."""

    step: int
    params: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor
    count: torch.Tensor

    def to(self, device) -> "TrainState":
        return replace(self, params=self.params.to(device),
                       mu=self.mu.to(device), nu=self.nu.to(device),
                       count=self.count.to(device))


def make_lr_schedule(cfg: TrainConfig) -> Callable:
    """Staircase exponential decay with a floor, as optax
    ``exponential_decay(staircase=True, end_value=lr_clip)``:
    ``max(lr_init * decay_rate ** floor(step / (decay_epoch *
    epoch_steps)), lr_clip)`` in float32.  Takes an int or a tensor and
    returns a float32 tensor on the step's device."""
    o = cfg.optim
    steps = o.decay_epoch * o.epoch_steps
    clip = torch.maximum if o.decay_rate < 1.0 else torch.minimum

    def schedule(step) -> torch.Tensor:
        c = torch.as_tensor(step).to(torch.float32)
        init = torch.full_like(c, o.lr_init)
        if steps <= 0:
            return init
        rate = torch.full_like(c, o.decay_rate)
        v = torch.where(c <= 0, init,
                        init * torch.pow(rate, torch.floor(c / steps)))
        return clip(v, torch.full_like(c, o.lr_clip))

    return schedule


def seg_loss_terms(logits: torch.Tensor, labels: torch.Tensor,
                   mask: torch.Tensor,
                   class_weights: Optional[torch.Tensor],
                   ignore_label: Optional[int]):
    """Unnormalised weighted-CE terms: (sum(w·ce), sum(w), labels, valid).

    The weights depend only on labels and mask, never on params, so the
    batch loss ``Σ_b S_b / Σ_b W_b`` and its gradient ``Σ_b ∇S_b / Σ_b
    W_b`` accumulate block by block."""
    logits = logits.float()  # loss always in f32
    valid = mask
    if ignore_label is not None:
        valid = valid & (labels != ignore_label)
        if ignore_label == 0:
            labels = (labels - 1).clamp(min=0)
    c = logits.shape[-1]
    # labels outside [0, C) are excluded, not clamped toward class C-1; the
    # clamp below only makes the index safe for already-masked rows
    valid = valid & (labels >= 0) & (labels < c)
    labels = labels.clamp(0, c - 1)
    ce = -torch.log_softmax(logits, dim=-1).gather(
        -1, labels[..., None].long())[..., 0]
    w = torch.ones_like(ce) if class_weights is None \
        else class_weights[labels.long()]
    w = w * valid.to(ce.dtype)
    return (w * ce).sum(), w.sum(), labels, valid


def seg_loss(logits, labels, mask, class_weights, ignore_label):
    """Weighted sparse softmax CE over valid (+ non-ignored) points:
    (loss, effective labels, effective mask)."""
    s, w, labels, valid = seg_loss_terms(logits, labels, mask,
                                         class_weights, ignore_label)
    return s / w.clamp(min=1e-6), labels, valid


def adam_update(state: TrainState, grads: torch.Tensor, loss: torch.Tensor,
                schedule: Callable) -> Tuple[TrainState, torch.Tensor]:
    """optax ``adam(schedule)`` on the flat vector, plus the guard: a step
    whose loss or gradient is non-finite changes no param and leaves the
    moments and the count as they were (``step`` still advances).  Returns
    (new state, good)."""
    good = torch.isfinite(loss) & torch.isfinite(grads).all()
    mu = (1 - B1) * grads + B1 * state.mu
    nu = (1 - B2) * (grads * grads) + B2 * state.nu
    count = state.count + 1
    c = count.to(torch.float32)
    mu_hat = mu / (1 - torch.pow(torch.full_like(c, B1), c))
    nu_hat = nu / (1 - torch.pow(torch.full_like(c, B2), c))
    upd = -schedule(state.count) * (mu_hat / (torch.sqrt(nu_hat) + EPS))
    upd = torch.where(good, upd, torch.zeros_like(upd))
    return TrainState(step=state.step + 1, params=state.params + upd,
                      mu=torch.where(good, mu, state.mu),
                      nu=torch.where(good, nu, state.nu),
                      count=torch.where(good, count, state.count)), good


def _bind_flat(model: nn.Module, layout, flat: torch.Tensor,
               grad: torch.Tensor) -> None:
    """Make every parameter of ``model`` a view into ``flat`` and its
    ``.grad`` the matching view into ``grad``: backward then accumulates in
    place into the flat gradient."""
    for leaf in layout:
        *mods, name = leaf.key.split(".")
        module = model.get_submodule(".".join(mods))
        p = nn.Parameter(leaf.view(flat))
        p.grad = leaf.view(grad)
        setattr(module, name, p)


class Trainer:
    """Owns the model, the flat parameter and gradient buffers and the
    class weights; ``train_step``/``eval_step`` map (state, batch) to
    (state, metrics) like the JAX trainer, on ``device`` (the card unless
    the caller asks for the CPU).  A state's tensors are never written in
    place, so an old state stays valid after a step.

    With a ``mesh`` (``parallel.mesh.Mesh`` on this ``device``) every batch
    a method takes is this rank's blocks (``parallel.mesh.shard_batch`` of
    the global batch; every rank holds as many) and every loss, gradient
    and metric it returns is the global batch's."""

    def __init__(self, cfg: TrainConfig, device="cuda",
                 search_chunk: int = 1024, mesh: Optional[Mesh] = None,
                 **encoder_kw):
        self.cfg = cfg
        self.device = torch.device(device)
        if mesh is not None and mesh.device != self.device:
            raise ValueError(f"the mesh's rank runs on {mesh.device}, the "
                             f"trainer on {self.device}")
        self.mesh = mesh
        # the group the steps reduce over (a lone process has none)
        self._group = None if mesh is None else mesh.group
        self.model = build_model(cfg, None, self.device,
                                 search_chunk=search_chunk, **encoder_kw)
        self.layout = ravel_layout(self.model)
        p = self.layout[-1].offset + self.layout[-1].size
        self._flat = torch.zeros(p, dtype=torch.float32, device=self.device)
        self._grad = torch.zeros_like(self._flat)
        _bind_flat(self.model, self.layout, self._flat, self._grad)
        self._encoder_kw = dict(search_chunk=search_chunk, **encoder_kw)
        d = cfg.data
        self.class_weights = None if d.class_weights is None else \
            torch.tensor(d.class_weights, dtype=torch.float32,
                         device=self.device)
        self.lr_schedule = make_lr_schedule(cfg)

    @property
    def num_params(self) -> int:
        return self._flat.numel()

    def lr_at(self, step) -> float:
        """The learning rate at optimizer count ``step``, for curve logging
        (the reference's tf.summary lr scalar)."""
        return float(self.lr_schedule(int(step)))

    def bind(self, state: TrainState) -> nn.Module:
        """The model with ``state``'s parameters (copied into the flat
        buffer its parameters view), e.g. for ``eval_scene_probs``."""
        self._flat.copy_(state.params)
        return self.model

    # -- init ------------------------------------------------------------
    def init_state(self, generator: Optional[torch.Generator] = None,
                   state: Optional[TrainState] = None) -> TrainState:
        """A fresh state with Glorot weights drawn from ``generator`` (on
        the CPU, as ``build_model`` draws them) and zero moments, or
        ``state`` (e.g. from ``convert.flax_train_state_to_torch``) moved
        to the trainer's device after a size check."""
        if state is None:
            if generator is None:
                raise ValueError("init_state needs a generator or a state")
            cpu = build_model(self.cfg, generator, "cpu", **self._encoder_kw)
            flat = ravel_params(cpu, self.layout).to(self.device)
            state = TrainState(step=0, params=flat,
                               mu=torch.zeros_like(flat),
                               nu=torch.zeros_like(flat),
                               count=torch.zeros((), dtype=torch.int32,
                                                 device=self.device))
        if state.params.shape != self._flat.shape:
            raise ValueError(f"state has {tuple(state.params.shape)} "
                             f"params, the model {self.num_params}")
        state = state.to(self.device)
        return state if self.mesh is None else replicate(state, self.mesh)

    # -- steps -----------------------------------------------------------
    def _dropout_generator(self, step: int, block: int) -> torch.Generator:
        """The dropout stream of global block ``block`` of step ``step``,
        seeded from (cfg.seed, step, block): a step repeats, and a block
        draws the same stream on whichever rank it lands."""
        seed = np.random.SeedSequence(
            [self.cfg.seed, step, block]).generate_state(1, np.uint64)[0]
        return torch.Generator(self.device).manual_seed(
            int(seed) & 0x7FFFFFFFFFFFFFFF)

    def _block_metrics(self, logits, labels_eff, valid):
        preds = logits.argmax(-1)
        cm = metrics_lib.confusion_matrix(labels_eff, preds,
                                          self.cfg.data.num_classes,
                                          mask=valid)
        return cm, ((preds == labels_eff) & valid).sum(), valid.sum()

    def _block_terms(self, batch: Dict, b: int, train: bool,
                     gen: Optional[torch.Generator]):
        """Block ``b``'s forward and unnormalised loss terms, the body the
        per-block loop runs (JAX ``train/loop.py:288-300``): (s, w, the
        metric row's logits, its effective labels, its valid mask)."""
        d = self.cfg.data
        extra_keys = getattr(self.model, "extra_keys", ())
        logits = self.model(batch["xyz"][b], batch["feats"][b],
                            batch["mask"][b],
                            *(batch[k][b] for k in extra_keys),
                            train=train, generator=gen)
        labels, mask = batch["labels"][b], batch["mask"][b]
        if logits.dim() == 1:
            # one cloud: its logits, its label, and whether it has a valid
            # point (a padding cloud of a test batch has none and counts
            # nothing)
            logits, labels, mask = logits[None], labels[:1], mask.any()[None]
        base = None
        if logits.dim() == 3:
            logits, base = logits[0], logits[1]
        s, w, labels_eff, valid = seg_loss_terms(
            logits, labels, mask, self.class_weights, d.ignore_label)
        if base is not None:
            s = s + BASE_LOSS_WEIGHT * seg_loss_terms(
                base, labels, mask, self.class_weights, d.ignore_label)[0]
        return s, w, logits, labels_eff, valid

    def _accum(self, state: TrainState, batch: Dict, train: bool,
               grad: bool):
        """Per-block forward (+ backward into the flat gradient), block
        after block, each block's graph freed before the next starts.
        Returns (s, w, cm, correct, count) summed over the blocks (over
        every rank's blocks under a mesh, the flat gradient too)."""
        d = self.cfg.data
        batch = to_device(batch, self.device)
        self.bind(state)
        self._grad.zero_()
        nb = batch["xyz"].shape[0]
        first = 0 if self.mesh is None else self.mesh.rank * nb
        c = d.num_classes
        s_acc = torch.zeros((), dtype=torch.float32, device=self.device)
        w_acc = torch.zeros_like(s_acc)
        cm = torch.zeros((c, c), dtype=torch.int64, device=self.device)
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        count = torch.zeros_like(correct)
        with torch.set_grad_enabled(grad):
            for b in range(nb):
                gen = self._dropout_generator(state.step, first + b) \
                    if train else None
                with profiling.span("pcs.forward"):
                    s, w, logits, labels_eff, valid = self._block_terms(
                        batch, b, train, gen)
                if grad:
                    with profiling.span("pcs.backward"):
                        s.backward()
                s_acc += s.detach()
                w_acc += w
                bcm, bcorrect, bcount = self._block_metrics(
                    logits.detach(), labels_eff, valid)
                cm += bcm
                correct += bcorrect
                count += bcount
                del logits, s
        if self._group is not None:
            return self._all_reduce(s_acc, w_acc, cm, correct, count, grad)
        return s_acc, w_acc, cm, correct, count

    def _all_reduce(self, s, w, cm, correct, count, grad: bool):
        """The step's one collective: the flat gradient (when ``grad``),
        s, w, the confusion matrix, correct and count summed over the
        ranks in one ``all_reduce`` of a float64 buffer, which holds the
        float32 terms and the integer counts exactly (the summed gradient
        is rounded to float32 once)."""
        parts = ([self._grad] if grad else []) + [s[None], w[None],
                                                  cm.reshape(-1),
                                                  correct[None], count[None]]
        packed = torch.cat([p.double() for p in parts])
        torch.distributed.all_reduce(packed, group=self._group)
        n = self._grad.numel() if grad else 0
        if grad:
            self._grad.copy_(packed[:n])
        c2 = cm.numel()
        tail = packed[n:]
        return (tail[0].float(), tail[1].float(),
                tail[2:2 + c2].round().long().reshape(cm.shape),
                tail[2 + c2].round().long(), tail[3 + c2].round().long())

    def loss_and_grad(self, state: TrainState, batch: Dict,
                      train: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(batch loss, flat gradient ``Σ∇S_b / max(ΣW_b, 1e-6)``) at
        ``state.params``, without an update."""
        s, w, *_ = self._accum(state, batch, train, grad=True)
        denom = w.clamp(min=1e-6)
        return s / denom, self._grad / denom

    def _metrics(self, loss, cm, correct, count, good):
        return {"loss": loss, "correct": correct, "count": count, "cm": cm,
                "skipped": (~good).to(torch.int32)}

    def train_step(self, state: TrainState, batch: Dict
                   ) -> Tuple[TrainState, Dict]:
        """One optimizer step over the batch's blocks (batch arrays are
        [B, N, ...]).  Metrics are device tensors, and the step reads none
        of them back; each block's forward still waits on the card where
        it syncs (in the pyramid and the encoder's pools, none in the
        search or the backward: a profiled step shows them under
        ``pcs.forward``)."""
        s, w, cm, correct, count = self._accum(state, batch, True, True)
        denom = w.clamp(min=1e-6)
        loss = s / denom
        state, good = adam_update(state, self._grad / denom, loss,
                                  self.lr_schedule)
        return state, self._metrics(loss, cm, correct, count, good)

    def eval_step(self, state: TrainState, batch: Dict
                  ) -> Tuple[TrainState, Dict]:
        """Loss and metrics with ``train=False``; the state is unchanged."""
        s, w, cm, correct, count = self._accum(state, batch, False, False)
        good = torch.ones((), dtype=torch.bool, device=self.device)
        return state, self._metrics(s / w.clamp(min=1e-6), cm, correct,
                                    count, good)

    def step_flops(self, state: TrainState, batch: Dict) -> float:
        """Floating-point operations of ``train_step(state, batch)`` on this
        process, for MFU (JAX ``train/loop.py:393-424``): the body the
        per-block loop runs, block 0's training forward with its dropout
        stream, loss terms and backward, counted by
        ``torch.utils.flop_counter.FlopCounterMode`` and multiplied by the
        batch's blocks (under a mesh, this rank's).  The Adam update
        (O(params) elementwise) is left out, as JAX leaves it out.

        The counter counts matmul-family ops only (mm, addmm, bmm,
        baddbmm, convolution): the convs' projections and the search's
        distance products, the backward's on autograd's device thread
        too.  The gathers are indexed loads and the window-gather kernels
        are no ops to it, so the count is the same on the card and on the
        CPU, where the kernels' plain versions run (``chip_smoke.py``
        phase 21 holds them equal).  XLA's cost analysis of the JAX step
        counts every op, the TPU's one-hot matmuls that move rows among
        them, so this count cannot be set beside the TPU's
        (``BENCH_r05.json``).

        ``state`` is not changed, and the next ``train_step`` runs as it
        would have without this call."""
        from torch.utils.flop_counter import FlopCounterMode

        batch = to_device(batch, self.device)
        nb = batch["xyz"].shape[0]
        first = 0 if self.mesh is None else self.mesh.rank * nb
        self.bind(state)
        self._grad.zero_()
        counter = FlopCounterMode(display=False)
        with torch.enable_grad(), counter:
            s = self._block_terms(batch, 0, True, self._dropout_generator(
                state.step, first))[0]
            s.backward()
        self._grad.zero_()
        return float(counter.get_total_flops() * nb)

    # -- epochs ----------------------------------------------------------
    def run_epoch(self, state: TrainState, batches: Iterable[Dict],
                  train: bool = True) -> Tuple[TrainState, Dict]:
        """One pass over ``batches`` with metrics accumulated on the device
        and read back once at the end (and at log lines, every
        ``cfg.log_every`` steps); ``points_per_sec`` counts valid points,
        ``blocks_per_sec`` blocks, both counted on the host before
        transfer (the log lines count this rank's blocks; the result every
        rank's, summed by one ``all_reduce`` at the end of the epoch under
        a mesh)."""
        acc = metrics_lib.MetricAccumulator(self.cfg.data.num_classes)
        t0 = time.time()
        points = blocks = 0
        log_every = self.cfg.log_every
        sizes = []

        def counted(bs):
            for b in bs:
                sizes.append((int(np.asarray(b["mask"]).sum()),
                              b["xyz"].shape[0]))
                yield b

        step_fn = self.train_step if train else self.eval_step
        cm_dev = loss_dev = None
        nsteps = 0
        for i, batch in enumerate(device_prefetch(counted(iter(batches)),
                                                  self.device)):
            state, m = step_fn(state, batch)
            cm_dev = m["cm"] if cm_dev is None else cm_dev + m["cm"]
            loss_dev = m["loss"] if loss_dev is None \
                else loss_dev + m["loss"]
            nsteps += 1
            points += sizes[i][0]
            blocks += sizes[i][1]
            if train and i % log_every == 0:
                dt = time.time() - t0
                log.info("step %d loss %.5f | %.1f blocks/s %.0f points/s",
                         i, float(m["loss"]), blocks / dt, points / dt)
        if nsteps:
            acc.update(cm_dev)
            acc.loss_sum = float(loss_dev)
            acc.loss_n = nsteps
        if self._group is not None:
            total = torch.tensor([points, blocks], dtype=torch.int64,
                                 device=self.device)
            torch.distributed.all_reduce(total, group=self._group)
            points, blocks = (int(v) for v in total.tolist())
        res = acc.result()
        dt = max(time.time() - t0, 1e-9)
        res["points_per_sec"] = points / dt
        res["blocks_per_sec"] = blocks / dt
        return state, res
