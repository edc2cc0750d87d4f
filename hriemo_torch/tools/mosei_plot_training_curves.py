#!/usr/bin/env python3
"""Training curves from a trainer's ``outputs/train_log.csv`` (port of
``tools/mosei_plot_training_curves.py``, without pandas). matplotlib is
imported in ``main``.

    python -m hriemo_torch.tools.mosei_plot_training_curves --log_csv run/outputs/train_log.csv
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path


def read_log(path) -> dict:
    """The log's columns as lists of floats."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    return {c: [float(r[c]) if r[c] != "" else float("nan") for r in rows]
            for c in (rows[0] if rows else {})}


def main(argv=None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ap = argparse.ArgumentParser()
    ap.add_argument("--log_csv", type=str, default="outputs/train_log.csv")
    ap.add_argument("--out", type=str, default="figs/training_curves.png")
    args = ap.parse_args(argv)

    log = read_log(args.log_csv)
    fig, axes = plt.subplots(1, 3, figsize=(13, 4))
    axes[0].plot(log["epoch"], log["train_loss"], label="train")
    if "val_loss" in log:
        axes[0].plot(log["epoch"], log["val_loss"], label="val")
    axes[0].set_title("loss")
    axes[0].legend()
    metric_col = "val_auc" if "val_auc" in log else "val_acc"
    axes[1].plot(log["epoch"], log[metric_col])
    axes[1].set_title(metric_col)
    axes[2].plot(log["epoch"], log["mean_beta"])
    axes[2].set_title("mean β")
    for ax in axes:
        ax.set_xlabel("epoch")
    fig.tight_layout()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out, dpi=120)
    plt.close(fig)
    print(f"[Saved] {out}")
    return out


if __name__ == "__main__":
    main()
