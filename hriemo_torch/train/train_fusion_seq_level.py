#!/usr/bin/env python3
"""IEMOCAP sequence-level beta-fusion classifier trainer (port of
``hriemo/train/train_fusion_seq_level.py``; reference:
scripts/fusion/train_fusion_seq_level.py).

The JAX CLI's flags and outputs, plus ``--device`` (``cuda`` by default;
raises without a card, never falls back to the CPU): ``FusionClassifier``
over seq-level features with pad masks (stored 1 = valid, inverted to True
= PAD), fixed-bucket batches at the caps, softmax cross-entropy, AdamW at a
constant learning rate with grad-clip 5.0, ``label2id`` from all rows, the
checkpoint of the best val accuracy. Writes ``best_fusion_seq.pt``,
``meta.json`` and ``outputs/train_log.csv``.
``train_fusion_utter_level.py`` runs the same loop on utter-level features.

    python -m hriemo_torch.train.train_fusion_seq_level --synthetic 48
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--index_csv", type=str, default="data/iemocap_index_splits.csv")
    ap.add_argument("--audio_dir", type=str, default="features/seq_level/audio")
    ap.add_argument("--text_dir", type=str, default="features/seq_level/text")
    ap.add_argument("--uid_col", type=str, default=None)
    ap.add_argument("--label_col", type=str, default="label")
    ap.add_argument("--split_col", type=str, default="split")
    ap.add_argument("--d_model", type=int, default=768)
    ap.add_argument("--n_heads", type=int, default=8)
    ap.add_argument("--num_layers", type=int, default=2)
    ap.add_argument("--beta_hidden", type=int, default=256)
    ap.add_argument("--dropout", type=float, default=0.2)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--weight_decay", type=float, default=1e-2)
    ap.add_argument("--max_len_audio", type=int, default=500)
    ap.add_argument("--max_len_text", type=int, default=128)
    ap.add_argument("--out_dir", type=str, default="runs/fusion_seq")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--compute_dtype", type=str, default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    return ap.parse_args(argv)


def train_fusion_classifier(args, level: str) -> float:
    """The loop of both FusionClassifier trainers: ``level`` "seq" (padded
    sequences, buckets at the caps or the corpus max) or "utter" (one vector
    per modality). Returns the best val accuracy."""
    from ..data import (BucketBatcher, SeqLevelDataset, UtterLevelDataset, build_label2id,
                        read_index_csv)
    from ..data.batching import prefetch_to_device
    from ..device import resolve_device
    from ..models import FusionClassifier
    from ..parallel.train_step import (TrainConfig, create_train_state, make_eval_step,
                                       make_train_step)
    from ..utils import checkpoint as C
    from .common import (TrainLogWriter, dropout_seed, maybe_synthetic_iemocap, set_seed,
                         step_generator)

    device = resolve_device(args.device)
    set_seed(args.seed)
    args = maybe_synthetic_iemocap(args, seq_level=level == "seq")
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if device.type == "cuda":  # fp32 products stay fp32, as in the JAX package
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    rows, columns = read_index_csv(args.index_csv)
    # label2id from ALL rows, like the reference
    label2id = build_label2id(r[args.label_col] for r in rows)
    split = lambda name: [r for r in rows if r[args.split_col] == name]  # noqa: E731
    if level == "seq":
        mk = lambda name: SeqLevelDataset(  # noqa: E731
            split(name), args.audio_dir, args.text_dir, uid_col=args.uid_col,
            label_col=args.label_col, label2id=label2id, max_len_audio=args.max_len_audio,
            max_len_text=args.max_len_text, columns=columns)
    else:
        mk = lambda name: UtterLevelDataset(  # noqa: E731
            split(name), args.audio_dir, args.text_dir, uid_col=args.uid_col,
            label_col=args.label_col, label2id=label2id, columns=columns)
    train_ds, val_ds = mk("train"), mk("val")

    model = FusionClassifier(d_model=args.d_model, num_classes=len(label2id),
                             n_heads=args.n_heads, num_layers=args.num_layers,
                             beta_hidden=args.beta_hidden, dropout=args.dropout)
    model.init_weights(torch.Generator().manual_seed(args.seed))
    model.to(device)

    if level == "seq":
        # uncapped (0): bucket at the corpus max (zero-length buckets would
        # silently train on empty sequences)
        la, lt = args.max_len_audio, args.max_len_text
        if not la or not lt:
            las, lts = zip(*((train_ds[i]["h_a"].shape[0], train_ds[i]["h_t"].shape[0])
                             for i in range(len(train_ds))))
            la, lt = la or max(las), lt or max(lts)
        shape = dict(la=la, lt=lt)
    else:
        shape = dict(utter_level=True)
    train_loader = BucketBatcher(train_ds, args.batch_size, shuffle=True, seed=args.seed,
                                 drop_last=True, **shape)
    val_loader = BucketBatcher(val_ds, args.batch_size, drop_last=False, **shape)

    cfg = TrainConfig(
        loss_type="single_label", lr=args.lr, weight_decay=args.weight_decay, grad_clip=5.0,
        schedule="constant", total_steps=max(1, len(train_loader)) * args.epochs,
        compute_dtype=torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32)
    state = create_train_state(model, cfg)
    train_step = make_train_step(model, cfg)
    eval_step = make_eval_step(model, cfg)
    base_seed = dropout_seed(args.seed)

    log = TrainLogWriter(out_dir / "outputs" / "train_log.csv",
                         ["epoch", "train_loss", "val_loss", "val_acc", "mean_beta",
                          "epoch_time_s"])

    best_acc, best_state, best_epoch = -1.0, None, 0
    for epoch in range(1, args.epochs + 1):
        t0 = time.time()
        tr_losses = []
        for i, batch in enumerate(prefetch_to_device(iter(train_loader), device)):
            state, metrics = train_step(
                state, batch, step_generator(base_seed, epoch * 100000 + i, device))
            tr_losses.append(metrics["loss"])
        tr_loss = float(np.mean(torch.stack(tr_losses).double().cpu().numpy())) if tr_losses else 0.0

        va_losses, correct, total, betas = [], 0, 0, []
        for batch in prefetch_to_device(iter(val_loader), device):
            n_valid = batch["n_valid"]
            loss, logits, beta = eval_step(batch)
            va_losses.append(float(loss))
            preds = logits.argmax(-1).cpu().numpy()[:n_valid]
            correct += int((preds == batch["y"].cpu().numpy()[:n_valid]).sum())
            total += n_valid
            betas.append(beta.cpu().numpy()[:n_valid])
        va_loss = float(np.mean(va_losses)) if va_losses else 0.0
        va_acc = correct / max(1, total)
        mean_beta = float(np.concatenate(betas).mean()) if betas else 0.0
        dt = time.time() - t0

        print(f"Epoch {epoch}/{args.epochs} ({dt:.1f}s) | train loss {tr_loss:.4f} | "
              f"val loss {va_loss:.4f} | val acc {va_acc:.4f} | mean β {mean_beta:.3f}")
        log.append(epoch=epoch, train_loss=tr_loss, val_loss=va_loss, val_acc=va_acc,
                   mean_beta=mean_beta, epoch_time_s=round(dt, 2))
        if va_acc > best_acc:
            best_acc, best_epoch = va_acc, epoch
            best_state = C.state_dict_cpu(model)

    ckpt_path = out_dir / ("best_fusion_seq.pt" if level == "seq" else "best_fusion_utt.pt")
    C.save_torch_checkpoint(str(ckpt_path), {
        "model_state_dict": best_state, "args": vars(args), "label2id": label2id,
        "epoch": best_epoch, "val_acc": best_acc,
    })
    C.write_meta_json(str(out_dir / "meta.json"), {
        "model": "FusionClassifier", "level": level,
        "best_val_acc": best_acc, "epoch": best_epoch, "label2id": label2id,
    })
    print(f"[Saved] {ckpt_path} (best val acc {best_acc:.4f})")
    return best_acc


def main(argv=None):
    return train_fusion_classifier(parse_args(argv), "seq")


if __name__ == "__main__":
    main()
