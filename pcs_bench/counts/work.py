"""The work of one block, counted on the reference at the configuration's
shapes and compute dtype: the floating-point operations of its matmul-family
ops (``torch.utils.flop_counter``, forward, and backward where the block
trains), and the bytes of every windowed slab gather (K2) and slab-gradient
sum (K3) the block needs.  The count follows the configuration, not the
program: a later change that moves a matmul into a hand-written kernel or
drops a gather leaves it as it is."""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .. import data
from ..reference import gather, model as ref_model


def gather_bytes(calls: List[tuple], train: bool) -> float:
    """Bytes of the K2 calls, and for ``train`` of the K3 calls of every
    gather whose features take a gradient, each input byte read once and
    each output byte written once.  K2: features [N, F] and indices [N, K]
    in, [N, K, F] out.  K3 is two kernels: the map (indices in; starts
    [N/T, S+1] and order [N/T, T*K] int32 out) and the sum (slot gradients
    [N, K, F], starts and order in; slab gradients [N/T, S, F] out)."""
    total = 0.0
    for n, k, f, es, window, tile, grad in calls:
        total += n * f * es + n * k * 4 + n * k * f * es
        if train and grad:
            nt, s = n // tile, tile + 2 * window
            map_out = nt * (s + 1) * 4 + nt * tile * k * 4
            total += n * k * 4 + map_out
            total += n * k * f * es + map_out + nt * s * f * es
    return total


def block_work(cfg: Dict, points: int, train: bool, device) -> Dict:
    """{"flops": ..., "gather_bytes": ...} of one block of ``points`` valid
    points, run on the reference built in the configuration's compute
    dtype with zero weights (the count depends on shapes only)."""
    from torch.utils.flop_counter import FlopCounterMode

    m = ref_model.build(cfg, device, cfg["compute_dtype"])
    blk = data.room_block(np.random.RandomState(0), points,
                          cfg["num_classes"], cfg["feat_dim"],
                          cfg["block_size"], 1 / 3, 1 / 3)
    xyz, feats, mask, labels = (torch.from_numpy(blk[k]).to(device) for k in
                                ("xyz", "feats", "mask", "labels"))
    cw = torch.tensor(cfg["class_weights"], device=device)
    counter = FlopCounterMode(display=False)
    with gather.recording() as calls, counter, ref_model.no_tf32():
        with torch.set_grad_enabled(train):
            gen = torch.Generator(device).manual_seed(0)
            logits = m(xyz, feats, mask, train=train, generator=gen)
            if train:
                s, _ = ref_model.loss_terms(logits, labels, mask, cw)
                s.backward()
    return {"flops": float(counter.get_total_flops()),
            "gather_bytes": gather_bytes(calls, train)}
