"""Activation analysis and clustering for interpretability (the port's
counterpart of ``pointcloudsegmentation_tpu.eval.analysis``; SURVEY.md
§2.9):

- ``capture_activations``: one forward with a hook on every named
  submodule, returning each module's output under its flax path (the
  reference dumps its ``ops`` dict tensors, analysis.py / analysis_2.py /
  conv_analysis.py);
- ``activation_stats``: per-tensor moments (the matplotlib histogram
  dumps of analysis.py);
- ``kmeans`` / ``cluster_activations``: k-means over one intermediate
  feature map and a color-coded cluster dump (cluster_layer.py:6-238), in
  plain numpy (no sklearn).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn


def capture_activations(model: nn.Module, *args, **kwargs
                        ) -> Tuple[object, Dict[str, np.ndarray]]:
    """Forward ``model(*args, **kwargs)`` under ``torch.no_grad()`` ->
    (output, {path: activation}).

    Each module's output is keyed by its flax path, as flax's
    ``capture_intermediates`` names it: the submodule's name with ``.``
    turned into ``/``, plus ``/__call__`` (``__call__`` alone for the
    model itself).  A module called more than once keeps its first call's
    output.  A module that returns a tuple or list records each tensor in
    it as ``<path>/__call__/<i>`` (the JAX function cannot capture such a
    module: ROADMAP.md §3, R11); outputs that are not tensors are not
    recorded.  Values are copied to the host as float32 numpy arrays as
    each module returns; every hook is removed afterwards."""
    acts: Dict[str, np.ndarray] = {}
    called = set()

    def hook(key):
        def record(module, inputs, out):
            if key in called:
                return
            called.add(key)
            if isinstance(out, torch.Tensor):
                acts[key] = out.detach().float().cpu().numpy()
            elif isinstance(out, (tuple, list)):
                for i, o in enumerate(out):
                    if isinstance(o, torch.Tensor):
                        acts[f"{key}/{i}"] = o.detach().float().cpu().numpy()
        return record

    handles = []
    try:
        for name, mod in model.named_modules():
            key = name.replace(".", "/") + "/__call__" if name else "__call__"
            handles.append(mod.register_forward_hook(hook(key)))
        with torch.no_grad():
            out = model(*args, **kwargs)
    finally:
        for h in handles:
            h.remove()
    return out, acts


def activation_stats(acts: Dict[str, np.ndarray],
                     mask: Optional[np.ndarray] = None) -> Dict[str, Dict]:
    stats = {}
    for name, a in acts.items():
        a = np.asarray(a, np.float32)
        if mask is not None and a.ndim >= 1 and a.shape[0] == len(mask):
            a = a[mask]
        if a.size == 0:
            continue
        stats[name] = {
            "shape": list(np.asarray(a).shape),
            "mean": float(a.mean()), "std": float(a.std()),
            "min": float(a.min()), "max": float(a.max()),
            "frac_zero": float((a == 0).mean()),
        }
    return stats


def kmeans(x: np.ndarray, k: int, iters: int = 50,
           seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    centers = x[rng.choice(len(x), k, replace=False)]
    assign = np.zeros(len(x), np.int32)
    for _ in range(iters):
        d2 = ((x[:, None, :] - centers[None]) ** 2).sum(-1)
        new = d2.argmin(1).astype(np.int32)
        if (new == assign).all():
            break
        assign = new
        for c in range(k):
            sel = x[assign == c]
            if len(sel):
                centers[c] = sel.mean(0)
    return assign


def cluster_activations(acts: Dict[str, np.ndarray], layer: str, k: int = 8,
                        mask: Optional[np.ndarray] = None,
                        xyz: Optional[np.ndarray] = None,
                        dump_path: Optional[str] = None) -> np.ndarray:
    """K-means over one layer's per-point activations; optionally dump a
    cluster-colored cloud (cluster_layer.py's workflow)."""
    a = np.asarray(acts[layer], np.float32)
    valid = np.ones(len(a), bool) if mask is None else np.asarray(mask)
    assign = np.zeros(len(a), np.int32)
    assign[valid] = kmeans(a[valid], k)
    if dump_path and xyz is not None:
        from ..utils import viz
        viz.output_labeled_points(dump_path, np.asarray(xyz)[valid],
                                  assign[valid], num_classes=k)
    return assign
