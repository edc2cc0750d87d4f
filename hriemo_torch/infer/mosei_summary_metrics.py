#!/usr/bin/env python3
"""Summary metrics over inference artifacts (port of
``hriemo/infer/mosei_summary_metrics.py``; reference:
scripts/infer/mosei_summary_metrics.py), over the port's
``utils/metrics.py``.

Loads ``{split}_y_prob.npy`` / ``{split}_y_true.npy``, binarises truth at
> 0, applies calibrated thresholds from the checkpoint when present (else
0.5, reference :35-47), prints micro/macro-F1, macro-AUC and a per-class
table (F1, threshold, support), and writes
``{split}_summary_metrics.csv``.
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pred_dir", type=str, required=True)
    ap.add_argument("--split", type=str, default="val")
    ap.add_argument("--ckpt", type=str, default=None,
                    help="checkpoint carrying val_calibrated_thresholds")
    ap.add_argument("--emo_cols", nargs="+", default=[
        "emo_happy", "emo_sad", "emo_anger", "emo_fear", "emo_disgust", "emo_surprise"])
    return ap.parse_args(argv)


def main(argv=None):
    from ..utils import metrics as M

    args = parse_args(argv)
    pred_dir = Path(args.pred_dir)
    y_prob = np.load(pred_dir / f"{args.split}_y_prob.npy")
    y_true_raw = np.load(pred_dir / f"{args.split}_y_true.npy")
    y_true = M.binarize_truth(y_true_raw)

    thresholds = np.full(y_true.shape[1], 0.5)
    if args.ckpt:
        from ..utils.checkpoint import load_torch_checkpoint

        ckpt = load_torch_checkpoint(args.ckpt)
        ths = ckpt.get("val_calibrated_thresholds")
        if ths is not None:
            thresholds = np.asarray(ths, dtype=np.float64)
            print(f"[thresholds] calibrated from ckpt: {np.round(thresholds, 2)}")
        else:
            print("[thresholds] none in ckpt, using 0.5")

    y_pred = M.apply_thresholds(y_prob, thresholds)
    micro = M.micro_f1(y_true, y_pred)
    macro = M.macro_f1(y_true, y_pred)
    auc = M.macro_auc(y_true, y_prob)
    print(f"[{args.split}] micro-F1 {micro:.4f} | macro-F1 {macro:.4f} | macro-AUC {auc:.4f}")

    rows = []
    print(f"{'class':<14}{'F1':>8}{'th':>6}{'support':>9}{'AUC':>8}")
    for c, name in enumerate(args.emo_cols[: y_true.shape[1]]):
        f1 = M.f1_binary(y_true[:, c], y_pred[:, c])
        a = M.roc_auc(y_true[:, c], y_prob[:, c])
        sup = int(y_true[:, c].sum())
        print(f"{name:<14}{f1:>8.4f}{thresholds[c]:>6.2f}{sup:>9}{a:>8.4f}")
        rows.append({"class": name, "f1": f1, "threshold": thresholds[c],
                     "support": sup, "auc": a})

    out_csv = pred_dir / f"{args.split}_summary_metrics.csv"
    with open(out_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["class", "f1", "threshold", "support", "auc"])
        w.writeheader()
        w.writerows(rows)
    print(f"[Saved] {out_csv}")
    return {"micro_f1": micro, "macro_f1": macro, "macro_auc": auc}


if __name__ == "__main__":
    main()
