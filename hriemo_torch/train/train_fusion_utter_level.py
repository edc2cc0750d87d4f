#!/usr/bin/env python3
"""IEMOCAP utterance-level beta-fusion classifier trainer (port of
``hriemo/train/train_fusion_utter_level.py``; reference:
scripts/fusion/train_fusion_utter_level.py).

The JAX CLI's flags and outputs, plus ``--device`` (``cuda`` by default;
raises without a card): ``FusionClassifier`` on precomputed utter-level
features (one ``[d]`` vector per modality, fed as ``[B, 1, d]``),
cross-entropy, AdamW (lr 1e-4, weight decay 1e-2), ``label2id`` from the
sorted labels of all rows, the best val accuracy kept, batch 32. Writes
``best_fusion_utt.pt``, ``meta.json`` and ``outputs/train_log.csv``; the
loop is ``train_fusion_seq_level.train_fusion_classifier``'s.

    python -m hriemo_torch.train.train_fusion_utter_level --synthetic 48
"""

from __future__ import annotations

import argparse

from .train_fusion_seq_level import train_fusion_classifier


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--index_csv", type=str, default="data/iemocap_index_splits.csv")
    ap.add_argument("--audio_dir", type=str, default="features/utter_level/audio")
    ap.add_argument("--text_dir", type=str, default="features/utter_level/text")
    ap.add_argument("--uid_col", type=str, default=None)
    ap.add_argument("--label_col", type=str, default="label")
    ap.add_argument("--split_col", type=str, default="split")
    ap.add_argument("--d_model", type=int, default=768)
    ap.add_argument("--n_heads", type=int, default=8)
    ap.add_argument("--num_layers", type=int, default=2)
    ap.add_argument("--beta_hidden", type=int, default=256)
    ap.add_argument("--dropout", type=float, default=0.2)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--weight_decay", type=float, default=1e-2)
    ap.add_argument("--out_dir", type=str, default="runs/fusion_utter")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--compute_dtype", type=str, default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    return train_fusion_classifier(parse_args(argv), "utter")


if __name__ == "__main__":
    main()
