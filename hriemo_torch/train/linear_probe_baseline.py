#!/usr/bin/env python3
"""Linear probe on utterance features (port of
``hriemo/train/linear_probe_baseline.py``; reference:
scripts/iemocap_feature_extraction_utter_level/linear_probe_baseline.py).

The JAX CLI's flags and ``metrics.json``, plus ``--device`` (``cuda`` by
default; raises without a card): one Linear on ``[audio; text]`` (2 x 768
by default) or one modality (``--modality``), labels and split names
normalised (``ang`` -> ``angry``, ``validation`` -> ``val``, ...),
``label2id`` from all rows, AdamW at ``--lr`` and ``--weight_decay`` (0.0
by default, as ``:79`` and ``:108`` give it) on the port's optimizer
update (``parallel/train_step.apply_update``, no clipping), shuffled
batches of ``--batch_size`` without the partial last, then accuracy and
macro-F1 on each split.

    python -m hriemo_torch.train.linear_probe_baseline --synthetic 64
"""

from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

import numpy as np
import torch


def normalize_label(lab: str) -> str:
    """Robust label canonicalisation (reference :50-74)."""
    lab = str(lab).strip().lower()
    aliases = {"ang": "angry", "hap": "happy", "exc": "excited", "neu": "neutral",
               "fru": "frustration", "frustrated": "frustration", "sadness": "sad"}
    return aliases.get(lab, lab)


def normalize_split(s: str) -> str:
    s = str(s).strip().lower()
    return {"validation": "val", "valid": "val", "dev": "val",
            "testing": "test", "training": "train"}.get(s, s)


def read_normalized(index_csv: str, label_col: str):
    """The index rows with labels and split names normalised, the CSV's
    columns, and ``label2id`` from all rows."""
    from ..data import build_label2id, read_index_csv

    rows, columns = read_index_csv(index_csv)
    for r in rows:
        r[label_col] = normalize_label(r[label_col])
        r["split"] = normalize_split(r["split"])
    return rows, columns, build_label2id(r[label_col] for r in rows)


def load_xy(rows, audio_dir, text_dir, modality, label2id, label_col="label", columns=None):
    """One split's features ``[N, d]`` fp32 (audio, text or both concatenated)
    and labels ``[N]`` int64."""
    from ..data import UtterLevelDataset

    ds = UtterLevelDataset(rows, audio_dir, text_dir, label_col=label_col, label2id=label2id,
                           verbose=False, columns=columns)
    if len(ds) == 0:
        return np.zeros((0, 0), np.float32), np.zeros((0,), np.int64)
    xs, ys = [], []
    for i in range(len(ds)):
        item = ds[i]
        if modality == "audio":
            x = item["h_a"]
        elif modality == "text":
            x = item["h_t"]
        else:
            x = np.concatenate([item["h_a"], item["h_t"]])
        xs.append(x)
        ys.append(int(item["y"]))
    return np.stack(xs), np.asarray(ys, np.int64)


def macro_f1_from_preds(y_true, y_pred, n_classes):
    from ..utils.metrics import f1_binary

    return float(np.mean([f1_binary((y_true == c).astype(int), (y_pred == c).astype(int))
                          for c in range(n_classes)]))


def normal_linear(d_in: int, d_out: int, gen: torch.Generator):
    """A Linear with weights N(0, 1) / sqrt(d_in) and zero bias, the JAX
    baselines' init (drawn from ``gen``: not JAX's bits)."""
    from ..nn.layers import Linear

    lin = Linear(d_in, d_out)
    with torch.no_grad():
        lin.weight.copy_(torch.randn(d_out, d_in, generator=gen) / math.sqrt(d_in))
    return lin


def fit(model, data, args, weight_decay: float, device, on_epoch=None, generator_of=None):
    """Cross-entropy training of ``model`` (``model(x, generator)`` gives
    logits) on ``data["train"]``: per epoch a permutation from
    ``np.random.default_rng(args.seed)``, batches of ``min(batch_size, N)``
    without the partial last, one AdamW update each (optax.adamw's, through
    ``apply_update`` with no clip). ``generator_of(epoch, i)`` gives the
    dropout generator of a step; ``on_epoch()`` runs after each epoch."""
    from ..parallel.train_step import TrainConfig, apply_update, create_train_state, make_schedule

    cfg = TrainConfig(lr=args.lr, weight_decay=weight_decay, grad_clip=math.inf,
                      schedule="constant")
    state, sched = create_train_state(model, cfg), make_schedule(cfg)
    params = list(model.parameters())
    x_train, y_train = (torch.from_numpy(a).to(device) for a in data["train"])
    rng = np.random.default_rng(args.seed)
    bs = min(args.batch_size, len(x_train))
    model.train()
    for epoch in range(args.epochs):
        order = rng.permutation(len(x_train))
        for i in range(0, len(order) - bs + 1, bs):
            idx = torch.from_numpy(order[i: i + bs]).to(device)
            gen = generator_of(epoch, i) if generator_of else None
            logits = model(x_train[idx], gen)
            loss = torch.nn.functional.cross_entropy(logits, y_train[idx])
            apply_update(state, list(torch.autograd.grad(loss, params)), cfg, sched)
        if on_epoch is not None:
            on_epoch()
    model.eval()


@torch.no_grad()
def evaluate(model, x, y, n_classes, device) -> dict:
    if len(x) == 0:
        return {"acc": 0.0, "macro_f1": 0.0, "n": 0}
    preds = model(torch.from_numpy(x).to(device), None).argmax(-1).cpu().numpy()
    return {"acc": float((preds == y).mean()),
            "macro_f1": macro_f1_from_preds(y, preds, n_classes), "n": int(len(y))}


class Head(torch.nn.Module):
    """``linear``: one Linear; ``mlp``: Linear -> ReLU -> dropout (in a
    training call, which passes a generator) -> Linear."""

    def __init__(self, head: str, d_in: int, hidden: int, n_classes: int, dropout: float,
                 gen: torch.Generator):
        super().__init__()
        self.dropout = dropout if head == "mlp" else 0.0
        if head == "mlp":
            self.hidden = normal_linear(d_in, hidden, gen)
            self.out = normal_linear(hidden, n_classes, gen)
        else:
            self.hidden = None
            self.out = normal_linear(d_in, n_classes, gen)

    def forward(self, x, generator=None):
        from ..nn.layers import dropout

        if self.hidden is not None:
            x = dropout(torch.relu(self.hidden(x)), self.dropout, generator,
                        generator is not None)
        return self.out(x)


def main(argv=None):
    from ..device import resolve_device
    from .common import maybe_synthetic_iemocap, set_seed

    ap = argparse.ArgumentParser()
    ap.add_argument("--index_csv", type=str, default="data/iemocap_index_splits.csv")
    ap.add_argument("--audio_dir", type=str, default="features/utter_level/audio")
    ap.add_argument("--text_dir", type=str, default="features/utter_level/text")
    ap.add_argument("--modality", choices=["audio", "text", "concat"], default="concat")
    ap.add_argument("--label_col", type=str, default="label")
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--weight_decay", type=float, default=0.0)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--d_model", type=int, default=768)  # for --synthetic
    ap.add_argument("--out_dir", type=str, default="runs/linear_probe")
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
                           args.text_dir, args.modality, label2id, args.label_col, columns)
            for split in ("train", "val", "test")}

    model = Head("linear", data["train"][0].shape[1], 0, n_classes, 0.0,
                 torch.Generator().manual_seed(args.seed)).to(device)
    fit(model, data, args, args.weight_decay, device)

    results = {}
    for split, (x, y) in data.items():
        if len(x) == 0:
            continue
        results[split] = evaluate(model, x, y, n_classes, device)
        print(f"[{args.modality}] {split}: acc={results[split]['acc']:.4f} "
              f"macro_f1={results[split]['macro_f1']:.4f} (n={len(y)})")

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "metrics.json", "w") as f:
        json.dump({"modality": args.modality, "label2id": label2id, **results}, f, indent=2)
    return results


if __name__ == "__main__":
    main()
