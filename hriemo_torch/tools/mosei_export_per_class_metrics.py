#!/usr/bin/env python3
"""Per-class metric export (port of ``tools/mosei_export_per_class_metrics.py``;
reference: tools/mosei_export_per_class_metrics.py).

AUC, AUPRC, F1 at 0.5 and F1 at the calibrated threshold per class, from
``{split}_y_prob.npy`` / ``{split}_y_true.npy``, to ``metrics_per_class.csv``.

    python -m hriemo_torch.tools.mosei_export_per_class_metrics --pred_dir preds --ckpt best.pt
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path

import numpy as np

from ..data.synthetic import MOSEI_EMO_COLS as EMO_COLS
from ..utils import metrics as M


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pred_dir", type=str, required=True)
    ap.add_argument("--split", type=str, default="val")
    ap.add_argument("--ckpt", type=str, default=None)
    ap.add_argument("--out_csv", type=str, default=None)
    args = ap.parse_args(argv)

    pred_dir = Path(args.pred_dir)
    y_prob = np.load(pred_dir / f"{args.split}_y_prob.npy")
    y_true = M.binarize_truth(np.load(pred_dir / f"{args.split}_y_true.npy"))

    cal_ths = None
    if args.ckpt:
        from ..utils.checkpoint import load_torch_checkpoint

        ths = load_torch_checkpoint(args.ckpt).get("val_calibrated_thresholds")
        if ths is not None:
            cal_ths = np.asarray(ths)
    if cal_ths is None:
        print(f"[WARN] no --ckpt thresholds: calibrating on the evaluated "
              f"'{args.split}' split itself — f1_at_calibrated is in-sample")
        cal_ths, _ = M.calibrate_thresholds(y_true, y_prob)

    rows = []
    for c in range(y_true.shape[1]):
        rows.append({
            "class": EMO_COLS[c] if c < len(EMO_COLS) else f"class_{c}",
            "auc": M.roc_auc(y_true[:, c], y_prob[:, c]),
            "auprc": M.average_precision(y_true[:, c], y_prob[:, c]),
            "f1_at_0.5": M.f1_binary(y_true[:, c], (y_prob[:, c] >= 0.5).astype(int)),
            "f1_at_calibrated": M.f1_binary(y_true[:, c],
                                            (y_prob[:, c] >= cal_ths[c]).astype(int)),
            "threshold": float(cal_ths[c]),
        })

    out_csv = Path(args.out_csv or pred_dir / "metrics_per_class.csv")
    out_csv.parent.mkdir(parents=True, exist_ok=True)
    with open(out_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    print(f"[Saved] {out_csv}")
    return out_csv


if __name__ == "__main__":
    main()
