#!/usr/bin/env python3
"""Text-only baseline: a linear or one-hidden-layer MLP head over utterance
text features (port of ``hriemo/train/train_text_baseline.py``; reference:
scripts/iemocap_feature_extraction_utter_level/train_text_baseline.py).

The JAX CLI's flags and ``metrics.json``, plus ``--device`` (``cuda`` by
default; raises without a card): ``--head {linear, mlp}`` (the MLP with
ReLU and dropout on its hidden layer in training), AdamW at ``--lr`` with
optax.adamw's default weight decay 1e-4, the parameters of the best val
macro-F1 kept (reference :136-139), accuracy and macro-F1 on each split.
The loop and the data are ``linear_probe_baseline``'s.

    python -m hriemo_torch.train.train_text_baseline --synthetic 64
"""

from __future__ import annotations

import argparse
import copy
import json
from pathlib import Path

import torch

from .linear_probe_baseline import Head, evaluate, fit, load_xy, read_normalized

ADAMW_DEFAULT_DECAY = 1e-4  # optax.adamw's weight_decay, which the JAX CLI keeps


def main(argv=None):
    from ..device import resolve_device
    from .common import dropout_seed, maybe_synthetic_iemocap, set_seed, step_generator

    ap = argparse.ArgumentParser()
    ap.add_argument("--index_csv", type=str, default="data/iemocap_index_splits.csv")
    ap.add_argument("--audio_dir", type=str, default="features/utter_level/audio")
    ap.add_argument("--text_dir", type=str, default="features/utter_level/text")
    ap.add_argument("--head", choices=["linear", "mlp"], default="mlp")
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--label_col", type=str, default="label")
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--dropout", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--d_model", type=int, default=768)  # for --synthetic
    ap.add_argument("--out_dir", type=str, default="runs/text_baseline")
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    set_seed(args.seed)
    args = maybe_synthetic_iemocap(args, seq_level=False)
    if device.type == "cuda":  # fp32 products stay fp32, as in the JAX package
        torch.backends.cuda.matmul.allow_tf32 = False

    rows, columns, label2id = read_normalized(args.index_csv, args.label_col)
    n_classes = len(label2id)
    data = {split: load_xy([r for r in rows if r["split"] == split], args.audio_dir,
                           args.text_dir, "text", label2id, args.label_col, columns)
            for split in ("train", "val", "test")}

    model = Head(args.head, data["train"][0].shape[1], args.hidden, n_classes,
                     args.dropout, torch.Generator().manual_seed(args.seed)).to(device)
    best = {"f1": -1.0, "model": copy.deepcopy(model)}

    def select_on_val():  # the reference selects on val macro-F1
        f1 = evaluate(model, *data["val"], n_classes, device)["macro_f1"]
        if f1 > best["f1"]:
            best.update(f1=f1, model=copy.deepcopy(model))

    base = dropout_seed(args.seed)
    fit(model, data, args, ADAMW_DEFAULT_DECAY, device, on_epoch=select_on_val,
        generator_of=lambda epoch, i: step_generator(base, epoch * 10000 + i, device))

    results = {split: evaluate(best["model"], *data[split], n_classes, device)
               for split in ("train", "val", "test")}
    for split, r in results.items():
        print(f"[text/{args.head}] {split}: acc={r['acc']:.4f} macro_f1={r['macro_f1']:.4f}")

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "metrics.json", "w") as f:
        json.dump({"head": args.head, "best_val_macro_f1": best["f1"],
                   "label2id": label2id, **results}, f, indent=2)
    return results


if __name__ == "__main__":
    main()
