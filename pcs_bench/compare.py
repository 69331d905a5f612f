"""The numbers that decide ``correct``: each reads the program's output
against the reference's, and each has a limit of its own in the cell's
limits file (``limits/<cell>.json``)."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def leaf_norms(leaves, flat: torch.Tensor) -> np.ndarray:
    """The norm of every leaf's slice of a flat float32 vector."""
    return np.array([float(flat[lf.offset:lf.offset + lf.size].double()
                           .norm()) for lf in leaves])


def leaf_norm_gap(leaves, prog: torch.Tensor, ref: torch.Tensor,
                  ref_grad: Optional[torch.Tensor] = None) -> float:
    """The worst leaf's gap between the program's norm and the reference's
    (a gap of norms, not the norm of the difference), over the larger of the
    reference's norm of that leaf and of the median leaf.  With
    ``ref_grad``, leaves whose reference gradient is under a thousandth of
    the median leaf's are left out: their change under Adam is round-off."""
    a, b = leaf_norms(leaves, prog), leaf_norms(leaves, ref)
    keep = np.ones(len(leaves), bool)
    if ref_grad is not None:
        g = leaf_norms(leaves, ref_grad)
        keep = g >= 1e-3 * np.median(g)
    scale = np.maximum(b, np.median(b[keep]))
    return float(np.max(np.abs(a - b)[keep] / scale[keep]))


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    """The largest relative gap between the program's loss and the
    reference's over the steps; inf where a loss is missing or not
    finite."""
    if len(prog) != len(ref):
        return float("inf")
    gaps = [abs(p - r) / abs(r) for p, r in zip(prog, ref)]
    return float(max(gaps)) if all(np.isfinite(gaps)) else float("inf")


def logit_gap(prog: List[torch.Tensor], ref: List[torch.Tensor]) -> float:
    """The largest |program - reference| logit over the blocks, over the
    reference's largest |logit|."""
    if len(prog) != len(ref):
        return float("inf")
    num = max(float((p.float() - r.float()).abs().max())
              for p, r in zip(prog, ref))
    den = max(float(r.abs().max()) for r in ref)
    return num / den if np.isfinite(num) else float("inf")


def prob_gaps(prog: np.ndarray, ref_logp: np.ndarray) -> Dict[str, float]:
    """Every point's probabilities against the reference's log-probabilities
    [M, C]: ``prob_gap_max``, the largest |program - reference| probability
    of any point; ``prob_gap_mean``, the mean over points of each point's
    largest gap; ``argmax_gap_max``, the widest gap by which the reference's
    log-probability of the class the program puts first lies below the
    reference's best (0 where they agree; an answer that names another class
    than a near-tie reads far).  inf if the shapes differ or a probability
    is not finite."""
    if prog.shape != ref_logp.shape or not np.isfinite(prog).all():
        return {"prob_gap_max": float("inf"),
                "prob_gap_mean": float("inf"),
                "argmax_gap_max": float("inf")}
    ref = np.exp(ref_logp.astype(np.float64))
    per_point = np.abs(prog.astype(np.float64) - ref).max(axis=1)
    top = np.take_along_axis(ref_logp, prog.argmax(1)[:, None], 1)[:, 0]
    return {"prob_gap_max": float(per_point.max()),
            "prob_gap_mean": float(per_point.mean()),
            "argmax_gap_max": float((ref_logp.max(1) - top).max())}


def judge(readings: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(every number within its limit, {name: {value, limit}}) over the
    numbers the limits file names; a limit with no number fails."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        v = readings.get(name, float("inf"))
        checks[name] = {"value": v, "limit": limit}
        ok &= bool(v <= limit)
    return ok, checks
