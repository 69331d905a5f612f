"""Drives ``Trainer.train_step``: closed-loop training steps, each issued
when the last call returned, on batches made in set-up and moved to the
device once (as the port's prefetching provider leaves them).

Set-up runs the first steps through the window's own call on batches
whose blocks all differ, and keeps what the reference needs to follow
them: the losses, the pyramid, neighbourhoods and logits of the first
step, the first gradient as Adam's state holds it after one step, and the
parameters after the last.  After the window the program is freed and the
reference runs the same steps in float32."""
from __future__ import annotations

import contextlib
from typing import Dict

import torch
from torch.profiler import record_function

from pointcloudsegmentation_tpu_torch.data.provider import to_device

from .. import capture, compare, data, program
from ..counts import work
from ..reference import model as ref_model

# Adam's first-moment decay: after one step from zero moments the first
# gradient is mu_1 / (1 - B1)
B1 = ref_model.B1


class Driver:
    """One training cell: ``unit`` is one optimizer step."""

    unit_name = "step"

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.host_batches = data.train_batches(cfg, traffic, seed)
        nsteps = traffic["batches"]
        self.blocks_per_unit = traffic["blocks_per_step"]
        self.points_per_unit = self.blocks_per_unit \
            * traffic["points_per_block"]
        self.trainer, self.leaves, flat0 = program.build(cfg, seed,
                                                         self.device)
        self.batches = [to_device(b, self.device) for b in self.host_batches]
        self.flat0 = flat0.cpu()
        self.prog = self.first_steps(self.batches)
        self.issued = len(self.batches)
        self.skipped = torch.zeros((), dtype=torch.int64, device=self.device)

    def first_steps(self, batches) -> Dict:
        """The first steps from the initial weights, through the window's
        own call, one step on each batch, the first under the capture; the
        window carries on from the last.  Returns what ``follow`` returns,
        for the program."""
        state = program.fresh_state(self.flat0.to(self.device))
        losses = []
        with capture.capture(self.trainer.model) as cap:
            state, m = self.trainer.train_step(state, batches[0])
        losses.append(m["loss"])
        g1 = (state.mu / (1 - B1)).cpu()
        for b in batches[1:]:
            state, m = self.trainer.train_step(state, b)
            losses.append(m["loss"])
        self.state, self.last = state, m
        return {"losses": [float(v) for v in losses], "first": cap.blocks,
                "g1": g1, "params_n": state.params.cpu()}

    def unit(self) -> None:
        with record_function("bench.train_step"):
            self.state, self.last = self.trainer.train_step(
                self.state,
                self.batches[self.issued % len(self.batches)])
        self.skipped += self.last["skipped"]
        self.issued += 1

    def close(self) -> None:
        """The window's one host read: the last step's loss."""
        float(self.last["loss"])

    def failed(self) -> int:
        """Steps whose loss or gradient was not finite (skipped by the
        guard)."""
        return int(self.skipped)

    def block_work(self) -> Dict:
        return work.block_work(self.cfg, self.traffic["points_per_block"],
                               True, self.device)

    def free(self) -> None:
        """Drop the program and its device state."""
        self.trainer = self.state = self.last = self.batches = None
        self.skipped = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the reference -------------------------------------------------
    def follow(self, compute: str = "float32") -> Dict:
        """The reference's run of the set-up steps from the same weights and
        batches: losses, the first step's captures, the first gradient and
        the parameters after the last step."""
        cfg = self.cfg
        dev = self.device
        ref = ref_model.build(cfg, dev, compute)
        cw = torch.tensor(cfg["class_weights"], device=dev)
        params = self.flat0.to(dev)
        mu = torch.zeros_like(params)
        nu = torch.zeros_like(params)
        tseed = program.train_seed(self.seed)
        o = cfg["optim"]
        losses, g1, first = [], None, None
        with ref_model.no_tf32():
            for step, hb in enumerate(self.host_batches):
                ref_model.load_flat(ref, self.leaves, params)
                ref.zero_grad(set_to_none=True)
                b = {k: torch.from_numpy(v).to(dev) for k, v in hb.items()}
                s_acc = torch.zeros((), device=dev)
                w_acc = torch.zeros((), device=dev)
                hooks = capture.capture(ref) if step == 0 \
                    else contextlib.nullcontext()
                with hooks as cap:
                    for j in range(b["xyz"].shape[0]):
                        gen = ref_model.dropout_generator(tseed, step, j, dev)
                        logits = ref(b["xyz"][j], b["feats"][j],
                                     b["mask"][j], train=True, generator=gen)
                        s, w = ref_model.loss_terms(logits, b["labels"][j],
                                                    b["mask"][j], cw)
                        s.backward()
                        s_acc += s.detach()
                        w_acc += w
                        del logits, s
                if step == 0:
                    first = cap.blocks
                denom = w_acc.clamp(min=1e-6)
                loss = s_acc / denom
                grads = ref_model.flat_grad(ref, self.leaves) / denom
                if step == 0:
                    g1 = grads.cpu()
                losses.append(float(loss))
                lr = max(o["lr_init"] * o["decay_rate"] ** (
                    step // (o["decay_epoch"] * o["epoch_steps"])),
                    o["lr_clip"])
                params, mu, nu = ref_model.adam(params, mu, nu, step, grads,
                                                lr)
        return {"losses": losses, "first": first, "g1": g1,
                "params_n": params.cpu()}

    def readings(self, prog: Dict, ref: Dict) -> Dict[str, float]:
        """The numbers compared: ``prog`` (the program's ``first_steps``, or
        a ``follow`` in its place) against ``ref`` (the float32
        ``follow``)."""
        a, b = prog["first"], ref["first"]

        def mismatch(part):
            if len(a) != len(b):
                return float("inf")
            return float(sum(capture.mismatches(x[part], y[part])
                             for x, y in zip(a, b)))

        return {
            "pyramid_mismatch": mismatch("pyramid"),
            "neighbour_mismatch": mismatch("neighbours"),
            "logit_gap": compare.logit_gap([x["logits"] for x in a],
                                           [y["logits"] for y in b]),
            "loss_gap": compare.loss_gap(prog["losses"], ref["losses"]),
            "first_loss_gap": compare.loss_gap(prog["losses"][:1],
                                               ref["losses"][:1]),
            "grad_gap": compare.leaf_norm_gap(self.leaves, prog["g1"],
                                              ref["g1"]),
            "update_gap": compare.leaf_norm_gap(
                self.leaves, prog["params_n"] - self.flat0,
                ref["params_n"] - self.flat0, ref["g1"]),
        }

    def check(self) -> Dict[str, float]:
        return self.readings(self.prog, self.follow("float32"))
