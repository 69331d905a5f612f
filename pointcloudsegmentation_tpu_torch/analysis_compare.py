"""Cross-run training-curve comparison (SURVEY.md §2.9, component #51);
the port's own copy of ``scripts/analysis_compare.py``, host only (numpy,
and matplotlib for the figures).

In place of the reference's log-grepping analysis scripts
(analysis_feats_compare.py:1-183), each run of the train CLI
(``train/cli.py``) writes a machine-readable ``metrics.jsonl``
(``--metrics-file``, ``--log-file`` or the checkpoint directory's), and
this tool renders the three artifacts the reference produced:

  1. mIoU-vs-epoch comparison curves across runs (ablation_figure /
     absense_figure analogs),
  2. per-class IoU curves for one run (iou_class_figure analog),
  3. a final/best summary table on stdout.

A regex fallback parses the CLI's log lines directly, so runs without a
JSONL still work (mirroring read_mious/read_maccs semantics).  It reads
files only and runs on no device.

Usage:
  python -m pointcloudsegmentation_tpu_torch.analysis_compare \
      runA.metrics.jsonl runB.metrics.jsonl --labels baseline drop-rgb \
      --out-dir results/compare
  python -m pointcloudsegmentation_tpu_torch.analysis_compare train.log \
      --class-names s3dis --per-class --out-dir results/compare
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys

import numpy as np

# train/cli.py epoch line:  "epoch 3 train-loss 1.2 | test mIoU 0.61 oIoU ..."
_EPOCH_RE = re.compile(
    r"epoch (\d+) train-loss ([\d.eE+-]+) \| test mIoU ([\d.eE+-]+) "
    r"oIoU ([\d.eE+-]+) oAcc ([\d.eE+-]+)")
_CLASS_RE = re.compile(r"class (\d+) iou ([\d.eE+-]+) acc ([\d.eE+-]+)")

def _s3dis_names():
    return ("ceiling", "floor", "wall", "beam", "column", "window", "door",
            "table", "chair", "sofa", "bookcase", "board", "clutter")


def load_run(path: str):
    """-> list of per-epoch dicts with at least epoch/miou/oacc.

    ``path`` may be a run DIRECTORY (a checkpoint_dir) — its
    ``metrics.jsonl`` is resolved, so ``python -m
    pointcloudsegmentation_tpu_torch.analysis_compare <run_dir> --curves``
    is the one-command training-curve artifact for any run."""
    if os.path.isdir(path):
        path = os.path.join(path, "metrics.jsonl")
    records = []
    with open(path) as f:
        first = f.read(1)
        f.seek(0)
        if first == "{":                       # JSONL
            for line in f:
                line = line.strip()
                if line:
                    records.append(json.loads(line))
        else:                                  # cli log fallback
            for line in f:
                m = _EPOCH_RE.search(line)
                if m:
                    records.append({
                        "epoch": int(m.group(1)),
                        "train_loss": float(m.group(2)),
                        "miou": float(m.group(3)),
                        "oiou": float(m.group(4)),
                        "oacc": float(m.group(5))})
    # drop --eval records (epoch=-1, split="eval" — cli.py appends them to
    # the same JSONL) and dedupe restored/re-run epochs, keeping the LAST
    # record per epoch so appended re-runs don't draw backward-jumping curves
    records = [r for r in records
               if "miou" in r and r.get("split") != "eval"
               and r.get("epoch", 0) >= 0]
    by_epoch = {r["epoch"]: r for r in records}
    return [by_epoch[e] for e in sorted(by_epoch)]


def curve(records, key):
    return np.array([r.get(key, np.nan) for r in records], dtype=np.float64)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("runs", nargs="+",
                   help="metrics.jsonl files or cli .log files")
    p.add_argument("--labels", nargs="*", default=None)
    p.add_argument("--metric", default="miou",
                   choices=["miou", "oiou", "oacc", "train_loss"])
    p.add_argument("--per-class", action="store_true",
                   help="also plot per-class IoU curves for the first run")
    p.add_argument("--class-names", default=None,
                   help="'s3dis' or comma-separated names")
    p.add_argument("--out-dir", default="results/analysis")
    p.add_argument("--curves", action="store_true",
                   help="per-run loss/lr/mIoU panel PNG for every run (the "
                        "reference's tf.summary scalar curves, "
                        "train_gpn_scannet_new.py:85,131,283)")
    args = p.parse_args(argv)

    labels = args.labels or [os.path.basename(r).split(".")[0]
                             for r in args.runs]
    assert len(labels) == len(args.runs), (labels, args.runs)
    runs = {lab: load_run(r) for lab, r in zip(labels, args.runs)}
    empty = [lab for lab, rec in runs.items() if not rec]
    if empty:
        sys.exit(f"no epoch records parsed from: {empty}")

    os.makedirs(args.out_dir, exist_ok=True)
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    # 1. cross-run metric curves
    fig, ax = plt.subplots(figsize=(8, 5), dpi=120)
    summary = {}
    for lab, rec in runs.items():
        y = curve(rec, args.metric)
        ax.plot(curve(rec, "epoch"), y, label=lab, linewidth=1.5)
        summary[lab] = {"final": float(y[-1]),
                        "best": float(np.nanmax(y)),
                        # the record's epoch field, not its index — restored
                        # runs start at epoch > 0
                        "best_epoch": int(rec[int(np.nanargmax(y))]["epoch"]),
                        "epochs": len(y)}
    ax.set_xlabel("epoch")
    ax.set_ylabel(args.metric)
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    out = os.path.join(args.out_dir, f"compare_{args.metric}.png")
    fig.savefig(out)
    plt.close(fig)

    # 1b. per-run training-curve panels: train_loss / lr / mIoU vs epoch
    if args.curves:
        for lab, rec in runs.items():
            epochs = curve(rec, "epoch")
            panels = [("train_loss", "train loss"), ("lr", "learning rate"),
                      ("miou", "test mIoU")]
            fig, axes = plt.subplots(1, 3, figsize=(13, 4), dpi=120)
            for ax_i, (key, title) in zip(axes, panels):
                y = curve(rec, key)
                if np.all(np.isnan(y)):
                    ax_i.set_title(f"{title} (no data)")
                    continue
                ax_i.plot(epochs, y, linewidth=1.5)
                ax_i.set_xlabel("epoch")
                ax_i.set_title(title)
                ax_i.grid(alpha=0.3)
                if key == "lr":
                    ax_i.set_yscale("log")
            fig.tight_layout()
            cpath = os.path.join(args.out_dir, f"curves_{lab}.png")
            fig.savefig(cpath)
            plt.close(fig)
            print(f"wrote {cpath}")

    # 2. per-class IoU curves (first run; needs JSONL records with 'iou')
    if args.per_class:
        lab0 = labels[0]
        rec0 = [r for r in runs[lab0] if "iou" in r]
        if rec0:
            names = None
            if args.class_names == "s3dis":
                names = _s3dis_names()
            elif args.class_names:
                names = args.class_names.split(",")
            ious = np.array([r["iou"] for r in rec0])       # [E, C]
            if names is None:
                names = [f"class{i}" for i in range(ious.shape[1])]
            fig, ax = plt.subplots(figsize=(9, 6), dpi=120)
            for c in range(ious.shape[1]):
                ax.plot(ious[:, c], label=names[c], linewidth=1.2)
            ax.set_xlabel("epoch")
            ax.set_ylabel("class IoU")
            ax.legend(fontsize=7, ncol=2)
            ax.grid(alpha=0.3)
            fig.tight_layout()
            fig.savefig(os.path.join(args.out_dir,
                                     f"per_class_{lab0}.png"))
            plt.close(fig)
        else:
            print(f"[warn] run '{lab0}' has no per-class records "
                  "(log-regex runs carry only scalar metrics)",
                  file=sys.stderr)

    # 3. summary table
    w = max(len(l) for l in labels)
    print(f"{'run':<{w}}  final_{args.metric}  best  best_epoch  epochs")
    for lab, s in summary.items():
        print(f"{lab:<{w}}  {s['final']:.4f}        {s['best']:.4f}"
              f"  {s['best_epoch']:>4d}       {s['epochs']}")
    with open(os.path.join(args.out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(f"wrote {out} and summary.json -> {args.out_dir}")
    return summary


if __name__ == "__main__":
    main()
