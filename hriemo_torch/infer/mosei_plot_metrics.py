#!/usr/bin/env python3
"""Metric plots over inference artifacts (port of
``hriemo/infer/mosei_plot_metrics.py``; reference:
scripts/infer/mosei_plot_metrics.py).

Per-class F1/AP bar charts, a combined 6-class PR figure, per-class PR
curves, and ``overall_metrics.txt``. A host tool: matplotlib is imported
inside ``main`` only.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pred_dir", type=str, required=True)
    ap.add_argument("--split", type=str, default="val")
    ap.add_argument("--out_dir", type=str, default=None)
    ap.add_argument("--emo_cols", nargs="+", default=[
        "emo_happy", "emo_sad", "emo_anger", "emo_fear", "emo_disgust", "emo_surprise"])
    return ap.parse_args(argv)


def _pr_curve(y_true, y_score):
    order = np.argsort(-y_score, kind="mergesort")
    y = y_true[order]
    tp = np.cumsum(y)
    precision = tp / np.arange(1, len(y) + 1)
    recall = tp / max(1, y_true.sum())
    return precision, recall


def main(argv=None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..utils import metrics as M

    args = parse_args(argv)
    pred_dir = Path(args.pred_dir)
    out_dir = Path(args.out_dir or pred_dir / "figs")
    out_dir.mkdir(parents=True, exist_ok=True)

    y_prob = np.load(pred_dir / f"{args.split}_y_prob.npy")
    y_true = M.binarize_truth(np.load(pred_dir / f"{args.split}_y_true.npy"))
    names = args.emo_cols[: y_true.shape[1]]

    f1s = [M.f1_binary(y_true[:, c], (y_prob[:, c] >= 0.5).astype(int)) for c in range(len(names))]
    aps = [M.average_precision(y_true[:, c], y_prob[:, c]) for c in range(len(names))]

    # per-class bars
    for vals, label, fname in [(f1s, "F1@0.5", "per_class_f1.png"),
                               (aps, "Average precision", "per_class_ap.png")]:
        fig, ax = plt.subplots(figsize=(7, 4))
        ax.bar(range(len(names)), vals)
        ax.set_xticks(range(len(names)), [n.replace("emo_", "") for n in names], rotation=30)
        ax.set_ylabel(label)
        fig.tight_layout()
        fig.savefig(out_dir / fname, dpi=120)
        plt.close(fig)

    # combined PR curve ("for the paper", reference :59-80)
    fig, ax = plt.subplots(figsize=(6, 5))
    for c, name in enumerate(names):
        p, r = _pr_curve(y_true[:, c], y_prob[:, c])
        ax.plot(r, p, label=name.replace("emo_", ""))
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_dir / "combined_pr_curve.png", dpi=120)
    plt.close(fig)

    # per-class PR curves
    for c, name in enumerate(names):
        fig, ax = plt.subplots(figsize=(5, 4))
        p, r = _pr_curve(y_true[:, c], y_prob[:, c])
        ax.plot(r, p)
        ax.set_title(name)
        ax.set_xlabel("Recall")
        ax.set_ylabel("Precision")
        fig.tight_layout()
        fig.savefig(out_dir / f"pr_{name}.png", dpi=120)
        plt.close(fig)

    micro = M.micro_f1(y_true, (y_prob >= 0.5).astype(int))
    macro = M.macro_f1(y_true, (y_prob >= 0.5).astype(int))
    auc = M.macro_auc(y_true, y_prob)
    with open(out_dir / "overall_metrics.txt", "w") as f:
        f.write(f"split: {args.split}\nmicro_f1@0.5: {micro:.4f}\n"
                f"macro_f1@0.5: {macro:.4f}\nmacro_auc: {auc:.4f}\n"
                f"macro_ap: {np.nanmean(aps):.4f}\n")
    print(f"[Saved] plots + overall_metrics.txt to {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
