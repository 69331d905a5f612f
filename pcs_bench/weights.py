"""Weights made on the device from the seed, in a few large calls."""
from __future__ import annotations

from typing import List

import numpy as np
import torch


def torch_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed for stream ``stream`` of run seed ``seed``."""
    s = np.random.SeedSequence([seed & (2 ** 64 - 1), stream])
    return int(s.generate_state(1, np.uint64)[0]) & 0x7FFFFFFFFFFFFFFF


def glorot_flat(leaves: List, seed: int, device) -> torch.Tensor:
    """The flat float32 parameter vector in ``leaves``' order: every drawn
    leaf (a Dense kernel, a GPN ``pw``) uniform in (-l, l) with its Glorot
    limit l, every constant leaf its constant.  One uniform draw on
    ``device`` from a generator seeded by ``seed`` over the whole vector,
    scaled by a per-element limit (0 on a constant leaf, so a bias is the
    draw times 0); then, where a leaf's constant is not 0, the constants
    written over it.  The draw does not depend on which leaves are
    constant, and a layout of kernels and biases alone allocates nothing
    more on the device than the draw."""
    device = torch.device(device)
    gen = torch.Generator(device).manual_seed(torch_seed(seed, 0))
    sizes = torch.tensor([leaf.size for leaf in leaves], device=device)
    limits = torch.tensor([leaf.limit for leaf in leaves],
                          dtype=torch.float32, device=device)
    total = int(sum(leaf.size for leaf in leaves))
    u = torch.rand(total, generator=gen, device=device)
    flat = (2.0 * u - 1.0) * torch.repeat_interleave(limits, sizes,
                                                     output_size=total)
    if any(leaf.const for leaf in leaves):
        consts = torch.repeat_interleave(
            torch.tensor([leaf.const for leaf in leaves],
                         dtype=torch.float32, device=device), sizes,
            output_size=total)
        flat = torch.where(consts != 0, consts, flat)
    return flat
