"""Full-scene inference: block-sweep forward passes, per-point softmax, and
Gaussian k-NN interpolation back to the dense cloud (mirror of
``pointcloudsegmentation_tpu.eval.interpolate``)."""
from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..data import native

# S3DIS Gaussian ratio for 6-NN: 1/(2·0.075²) (interpolate.py:140)
S3DIS_RATIO = 1.0 / (2 * 0.075 * 0.075)


@torch.inference_mode()
def eval_scene_probs(model: nn.Module, blocks: Iterable[Dict],
                     extra_keys: Sequence[str] = ()
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-block forward -> (xyz_global [M, 3], probs [M, C]) of all valid
    sampled points, float32.

    blocks: dicts with xyz [N, 3], feats [N, F], mask [N] (numpy arrays or
    tensors), optionally block_min [3], and the per-pipeline extras
    (``ctx_*`` / ``dense_*``) that ``extra_keys`` names, passed in that
    order after (xyz, feats, mask) (JAX ``eval/interpolate.py:27-58``).
    ``model(xyz, feats, mask, *extras)`` returns logits [N, C], or [2, N,
    C] for the refine cascade, whose refine row is used (JAX
    ``:47-49``); softmax runs in float32.  The sweep is issued without
    host synchronisation; probabilities come back in one transfer at the
    end."""
    dev = next(model.parameters()).device
    blocks = list(blocks)
    dev_probs = []
    for b in blocks:
        logits = model(*(torch.as_tensor(b[k], device=dev) for k in
                         ("xyz", "feats", "mask", *extra_keys)))
        if logits.dim() == 3:
            logits = logits[0]
        dev_probs.append(torch.softmax(logits.float(), dim=-1))
    all_xyz, all_probs = [], []
    for b, p in zip(blocks, dev_probs):
        m = torch.as_tensor(b["mask"]).cpu().numpy()
        bmin = np.asarray(b.get("block_min", np.zeros(3, np.float32)),
                          np.float32)
        all_xyz.append(torch.as_tensor(b["xyz"]).cpu().numpy()[m]
                       + bmin[None, :])
        all_probs.append(p.cpu().numpy()[m])
    return (np.concatenate(all_xyz, 0).astype(np.float32),
            np.concatenate(all_probs, 0).astype(np.float32))


def interpolate_to_dense(sxyz: np.ndarray, sprobs: np.ndarray,
                         qxyz: np.ndarray, k: int = 6,
                         ratio: float = S3DIS_RATIO) -> np.ndarray:
    """Gaussian k-NN interpolation of probs onto the dense cloud through the
    native host library (``csrc/pointutil.cpp``, built by ``data/native.py``
    at first use).  The device fallback is not ported: a failed build
    raises."""
    return native.interpolate_probs(sxyz, sprobs, qxyz, k, ratio,
                                    cell_hint=0.3)


def iou_from_confusion(cm: np.ndarray) -> Dict[str, np.ndarray]:
    """Per-class IoU/acc + mIoU/oIoU/overall acc from a confusion matrix."""
    cm = np.asarray(cm, np.float64)
    tp = np.diag(cm)
    fn = cm.sum(1) - tp
    fp = cm.sum(0) - tp
    denom = tp + fn + fp
    iou = np.where(denom > 0, tp / np.maximum(denom, 1), 0.0)
    acc = np.where(cm.sum(1) > 0, tp / np.maximum(cm.sum(1), 1), 0.0)
    present = cm.sum(1) > 0
    miou = iou[present].mean() if present.any() else 0.0
    oiou = tp.sum() / max(denom.sum(), 1)
    oacc = tp.sum() / max(cm.sum(), 1)
    return {"iou": iou, "acc": acc, "miou": miou, "oiou": oiou, "oacc": oacc}


def scene_iou(labels: np.ndarray, preds: np.ndarray,
              num_classes: int) -> Dict:
    cm = np.zeros((num_classes, num_classes), np.float64)
    np.add.at(cm, (labels.astype(np.int64), preds.astype(np.int64)), 1.0)
    return iou_from_confusion(cm)
