"""Drives ``eval.interpolate.eval_scene_probs``: closed-loop scene
labelling, each scene's block forwards and softmaxes issued without a sync
and its probabilities brought to the host in one transfer, the next scene
issued when the call returns.  The scenes are made in set-up, kept on the
device and taken in turn.

A sample of the scenes the window finished, drawn from the seed, is kept on
the host; after the window the program is freed and every kept scene's
probabilities are compared point by point with the reference's."""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from pointcloudsegmentation_tpu_torch.eval.interpolate import \
    eval_scene_probs

from .. import compare, data, program
from ..counts import work
from ..reference import model as ref_model


class Driver:
    """One labelling cell: ``unit`` is one scene."""

    unit_name = "scene"

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.host_scenes = data.scenes(cfg, traffic, seed)
        self.blocks_per_unit = traffic["blocks_per_scene"]
        self.points_per_unit = self.blocks_per_unit \
            * traffic["points_per_block"]
        trainer, self.leaves, flat = program.build(cfg, seed, self.device)
        self.flat = flat.cpu()
        self.model = trainer.bind(program.fresh_state(flat))
        self.scenes = [[{k: (torch.from_numpy(v).to(self.device)
                             if k in ("xyz", "feats", "mask") else v)
                         for k, v in b.items()} for b in scene]
                       for scene in self.host_scenes]
        self.pick = data.rng_for(seed, 4)
        self.kept: List[Tuple[int, np.ndarray]] = []
        self.bad = 0
        # warm: one scene
        eval_scene_probs(self.model, self.scenes[0])
        self.issued = 0
        self.last = None

    def unit(self) -> None:
        i = self.issued % len(self.scenes)
        with record_function("bench.scene"):
            _, probs = eval_scene_probs(self.model, self.scenes[i])
        self.bad += int(not np.isfinite(probs).all())
        if self.pick.rand() < self.traffic["sample_share"]:
            self.kept.append((i, probs))
        self.last = (i, probs)
        self.issued += 1

    def close(self) -> None:
        """Every scene is on the host when its call returns; the last one
        is always among those compared."""
        if self.last is not None and (not self.kept
                                      or self.kept[-1] is not self.last):
            self.kept.append(self.last)

    def failed(self) -> int:
        """Scenes with a probability that is not finite."""
        return self.bad

    def block_work(self) -> Dict:
        return work.block_work(self.cfg, self.traffic["points_per_block"],
                               False, self.device)

    def free(self) -> None:
        self.model = self.scenes = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the reference -------------------------------------------------
    def reference_logp(self, compute: str = "float32") -> List[np.ndarray]:
        """Per scene, the reference's float32 log-probabilities of its valid
        points in block order."""
        dev = self.device
        ref = ref_model.build(self.cfg, dev, compute)
        ref_model.load_flat(ref, self.leaves, self.flat.to(dev))
        out = []
        with ref_model.no_tf32(), torch.no_grad():
            for scene in self.host_scenes:
                parts = []
                for b in scene:
                    t = {k: torch.from_numpy(b[k]).to(dev)
                         for k in ("xyz", "feats", "mask")}
                    logits = ref(t["xyz"], t["feats"], t["mask"])
                    p = torch.log_softmax(logits.float(), dim=-1)
                    parts.append(p[t["mask"]].cpu().numpy())
                out.append(np.concatenate(parts, 0))
        return out

    def readings(self, kept: List[Tuple[int, np.ndarray]],
                 ref: List[np.ndarray]) -> Dict[str, float]:
        """The worst over the scenes ``kept`` ((scene, probabilities)
        pairs: the program's, or the control's in its place) of each
        ``compare.prob_gaps`` number against the reference's
        log-probabilities."""
        if not kept:
            return compare.prob_gaps(np.zeros(0), np.zeros(1))
        gaps = [compare.prob_gaps(p, ref[i]) for i, p in kept]
        return {k: max(g[k] for g in gaps) for k in gaps[0]}

    def check(self) -> Dict[str, float]:
        return self.readings(self.kept, self.reference_logp("float32"))
