"""IoU / accuracy metrics (mirror of
``pointcloudsegmentation_tpu.train.metrics``, which imports ``jax.numpy``
and so cannot be shared).

``confusion_matrix`` counts with integers, so it is exact and repeats bit
for bit; ``iou_from_confusion`` and ``MetricAccumulator`` are numpy on the
host."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def confusion_matrix(labels: torch.Tensor, preds: torch.Tensor,
                     num_classes: int,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[C, C] int64 counts; rows = true label, cols = prediction.  An
    integer bincount (a scatter-add of ones, with one extra bin for masked
    points) that needs no host synchronisation on the card."""
    c = num_classes
    idx = (labels.reshape(-1).long() * c + preds.reshape(-1).long())
    if mask is not None:
        idx = torch.where(mask.reshape(-1), idx, torch.full_like(idx, c * c))
    cm = torch.zeros(c * c + 1, dtype=torch.int64, device=idx.device)
    cm.scatter_add_(0, idx, torch.ones_like(idx))
    return cm[:c * c].reshape(c, c)


def iou_from_confusion(cm) -> Dict[str, np.ndarray]:
    """Per-class IoU/acc + mIoU/oIoU/overall acc from a confusion matrix
    (val2iou semantics, train_util.py:55-68)."""
    if isinstance(cm, torch.Tensor):
        cm = cm.cpu().numpy()
    cm = np.asarray(cm, np.float64)
    tp = np.diag(cm)
    fn = cm.sum(1) - tp
    fp = cm.sum(0) - tp
    denom = tp + fn + fp
    iou = np.where(denom > 0, tp / np.maximum(denom, 1), 0.0)
    acc = np.where(cm.sum(1) > 0, tp / np.maximum(cm.sum(1), 1), 0.0)
    present = cm.sum(1) > 0
    miou = iou[present].mean() if present.any() else 0.0
    # overall IoU: all classes pooled (the reference's oiou)
    oiou = tp.sum() / max(denom.sum(), 1)
    oacc = tp.sum() / max(cm.sum(), 1)
    return {"iou": iou, "acc": acc, "miou": miou, "oiou": oiou, "oacc": oacc}


class MetricAccumulator:
    """Host-side streaming accumulator across eval batches."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.cm = np.zeros((num_classes, num_classes), np.float64)
        self.loss_sum = 0.0
        self.loss_n = 0

    def update(self, cm, loss: Optional[float] = None):
        if isinstance(cm, torch.Tensor):
            cm = cm.cpu().numpy()
        self.cm += np.asarray(cm)
        if loss is not None:
            self.loss_sum += float(loss)
            self.loss_n += 1

    def result(self) -> Dict[str, np.ndarray]:
        out = iou_from_confusion(self.cm)
        if self.loss_n:
            out["loss"] = self.loss_sum / self.loss_n
        return out
