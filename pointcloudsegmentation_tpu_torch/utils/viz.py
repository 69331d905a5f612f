"""Visualization and dump utilities (reference: draw_util.py:9-159); the
port's own numpy copy of ``pointcloudsegmentation_tpu.utils.viz``.

Class color tables for S3DIS/ScanNet/Semantic3D, colored ``.txt``
point-cloud dumps for external viewers (``output_points``,
draw_util.py:105), and a confusion-matrix plot (draw_util.py:122), which
needs matplotlib and returns False without it."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

# 13 distinct colors for S3DIS classes (ceiling..clutter)
S3DIS_COLORS = np.array([
    [0, 255, 0], [0, 0, 255], [0, 255, 255], [255, 255, 0],
    [255, 0, 255], [100, 100, 255], [200, 200, 100], [170, 120, 200],
    [255, 0, 0], [200, 100, 100], [10, 200, 100], [200, 200, 200],
    [50, 50, 50]], np.uint8)

SEMANTIC3D_COLORS = np.array([
    [0, 0, 0], [200, 200, 200], [0, 70, 0], [0, 255, 0], [255, 255, 0],
    [100, 50, 0], [200, 100, 100], [255, 0, 0], [0, 0, 255]], np.uint8)


def class_colors(num_classes: int, seed: int = 0) -> np.ndarray:
    if num_classes == 13:
        return S3DIS_COLORS
    if num_classes == 9:
        return SEMANTIC3D_COLORS
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, (num_classes, 3)).astype(np.uint8)


def output_points(path: str, xyz: np.ndarray,
                  colors: Optional[np.ndarray] = None) -> None:
    """Dump ``x y z [r g b]`` lines (draw_util.output_points)."""
    xyz = np.asarray(xyz)
    with open(path, "w") as f:
        if colors is None:
            for p in xyz:
                f.write(f"{p[0]} {p[1]} {p[2]}\n")
        else:
            colors = np.asarray(colors)
            if colors.ndim == 1:  # labels -> colors
                colors = class_colors(int(colors.max()) + 1)[
                    colors.astype(int)]
            for p, c in zip(xyz, colors):
                f.write(f"{p[0]} {p[1]} {p[2]} "
                        f"{int(c[0])} {int(c[1])} {int(c[2])}\n")


def output_labeled_points(path: str, xyz: np.ndarray, labels: np.ndarray,
                          num_classes: Optional[int] = None) -> None:
    nc = num_classes or int(labels.max()) + 1
    output_points(path, xyz, class_colors(nc)[labels.astype(int)])


def plot_confusion_matrix(cm: np.ndarray, class_names: Sequence[str],
                          path: str, normalize: bool = True) -> bool:
    """Confusion-matrix heatmap; returns False if matplotlib is missing."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False
    cm = np.asarray(cm, np.float64)
    if normalize:
        cm = cm / np.maximum(cm.sum(1, keepdims=True), 1)
    fig, ax = plt.subplots(figsize=(8, 8))
    im = ax.imshow(cm, cmap="Blues")
    ax.set_xticks(range(len(class_names)))
    ax.set_yticks(range(len(class_names)))
    ax.set_xticklabels(class_names, rotation=90)
    ax.set_yticklabels(class_names)
    ax.set_xlabel("prediction")
    ax.set_ylabel("label")
    fig.colorbar(im)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return True
