"""Full-scene inference: block-sweep forward passes, per-point softmax, the
test-time rotation ensemble, Gaussian k-NN interpolation back to the dense
cloud, and the Semantic3D ``.labels`` submission (mirror of
``pointcloudsegmentation_tpu.eval.interpolate``)."""
from __future__ import annotations

from typing import (Dict, Iterable, Iterator, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch
from torch import nn

from ..data import native
from ..data.augment import rotate_z
from ..ops import interpolate as interp_ops
from ..utils import profiling

# the reference's Gaussian ratios: S3DIS 6-NN 1/(2·0.075²)
# (interpolate.py:140), Semantic3D 8-NN 1/(2·0.125²)
# (interpolate_semantic3d_new.py:88)
S3DIS_RATIO = 1.0 / (2 * 0.075 * 0.075)
SEMANTIC3D_RATIO = 1.0 / (2 * 0.125 * 0.125)


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
    ``:47-49``); softmax runs in float32.  Each block's forward waits on
    the card where it syncs (in the pyramid and the encoder's pools: a
    profiled sweep shows them under ``pcs.forward``); after the sweep each
    block's mask, xyz and probabilities come to the host, three transfers
    a block where the blocks are on the card."""
    dev = next(model.parameters()).device
    blocks = list(blocks)
    dev_probs = []
    for b in blocks:
        with profiling.span("pcs.forward"):
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


def eval_rot_ensemble_probs(model: nn.Module,
                            arms: Iterable[Tuple[float, Iterable[Dict]]],
                            extra_keys: Sequence[str] = ()
                            ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """The test-time rotation ensemble (JAX ``eval/interpolate.py:61-87``):
    each arm's block sweep (``eval_scene_probs``), its sampled points
    mapped back into the original frame.  ``arms``: (rot_ang, blocks)
    pairs, rot_ang the angle the prep rotated the whole scan by about z
    before cutting the arm's blocks (0.0 for the unrotated arm), so the
    inverse rotation of block xyz + block_min is the original frame
    (semantic3d_test_to_block_with_rotate, semantic3d_util.py:539-557).
    Yields (sxyz [M, 3] in the original frame, probs [M, C]) per arm; the
    caller interpolates each onto the dense cloud and averages."""
    for rot_ang, blocks in arms:
        sxyz, probs = eval_scene_probs(model, blocks, extra_keys=extra_keys)
        if rot_ang != 0.0:
            sxyz = rotate_z(np.ascontiguousarray(sxyz, np.float32),
                            -rot_ang)
        yield sxyz, probs


Array = Union[np.ndarray, torch.Tensor]


def interpolate_to_dense(sxyz: Array, sprobs: Array, qxyz: Array, k: int = 6,
                         ratio: float = S3DIS_RATIO, chunk: int = 200_000,
                         prefer_native: Optional[bool] = None) -> Array:
    """Gaussian k-NN interpolation of the sampled points' probabilities
    onto the dense cloud (JAX ``eval/interpolate.py:90-123``).

    ``prefer_native=True``, or None (the default, JAX's, which there
    falls back to the device arm without a native library): the native
    host library's hash grid k-NN (``csrc/pointutil.cpp``, built at first
    use; a failed build raises), on numpy arrays.  ``prefer_native=False``:
    the device arm, ``ops.interpolate.interpolate_probs_exact`` on the
    device of the arrays passed in (numpy arrays: the CPU), over ``chunk``
    queries at a time; it returns a tensor there.  Unlike the JAX device arm, whose k-NN scores
    the expanded ``|q|² + |s|² - 2 q·s``, it ranks the support by the
    distances of the coordinate differences, rounded as the native library
    rounds them (``ops.interpolate.knn_exact``), so both arms take the same
    neighbours.  The choice of arm is the caller's: neither stands in for
    the other."""
    if prefer_native is None or prefer_native:
        return native.interpolate_probs(np.asarray(sxyz), np.asarray(sprobs),
                                        np.asarray(qxyz), k, ratio,
                                        cell_hint=0.3)
    sxyz_t = torch.as_tensor(sxyz)
    dev = sxyz_t.device
    sprobs_t = torch.as_tensor(sprobs, device=dev)
    qxyz_t = torch.as_tensor(qxyz, device=dev)
    return torch.cat([interp_ops.interpolate_probs_exact(
        sxyz_t, sprobs_t, qxyz_t[beg:beg + chunk], k=k, ratio=ratio)
        for beg in range(0, len(qxyz_t), chunk)], 0)


def save_semantic3d_labels(path: str, probs: np.ndarray) -> np.ndarray:
    """Write a Semantic3D server submission, one label in 1..8 per line:
    the argmax over the model's 8 columns plus 1.  The port's Semantic3D
    model has one column per label 1..8 (label 0, unlabeled, is ignored in
    training), where the JAX writer takes 9 with column 0 unlabeled and
    excludes it (JAX ``eval/interpolate.py:133-141``,
    interpolate_semantic3d_new.py:92-111): both write the same labels.
    Returns the labels written."""
    preds = np.asarray(probs).argmax(1) + 1
    with open(path, "w") as f:
        f.write("\n".join(str(int(p)) for p in preds))
        f.write("\n")
    return preds


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
