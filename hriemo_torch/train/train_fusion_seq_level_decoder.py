#!/usr/bin/env python3
"""IEMOCAP seq-level trainer with the emotion-query decoder (port of
``hriemo/train/train_fusion_seq_level_decoder.py``; reference:
scripts/fusion/train_fusion_seq_level_decoder.py).

The JAX CLI's flags and outputs, plus ``--device`` (``cuda`` by default;
raises without a card, never falls back to the CPU): FusionWithEmotionDecoder;
``--loss_type {single_label, multi_label}`` (multi-label one-hots the single
primary label, reference :160-170); the beta anti-degeneracy regularizer
``loss - 0.01 * mean(beta (1 - beta))`` (reference :324-326); grad-clip 5.0;
a constant learning rate; multi-label accuracy is an exact match at 0.5.
Writes ``best_fusion_seq_decoder.pt`` (selected by val accuracy),
``meta.json`` and ``outputs/train_log.csv``.

    python -m hriemo_torch.train.train_fusion_seq_level_decoder --synthetic 48
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
    ap.add_argument("--loss_type", type=str, default="single_label",
                    choices=["single_label", "multi_label"])
    ap.add_argument("--d_model", type=int, default=768)
    ap.add_argument("--n_heads", type=int, default=8)
    ap.add_argument("--num_layers_fusion", type=int, default=2)
    ap.add_argument("--num_layers_decoder", type=int, default=2)
    ap.add_argument("--beta_hidden", type=int, default=256)
    ap.add_argument("--dropout", type=float, default=0.1)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--weight_decay", type=float, default=1e-2)
    ap.add_argument("--max_len_audio", type=int, default=500)
    ap.add_argument("--max_len_text", type=int, default=128)
    ap.add_argument("--out_dir", type=str, default="runs/fusion_seq_decoder")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--compute_dtype", type=str, default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    return ap.parse_args(argv)


class _OneHotDataset:
    """multi_label mode: one-hot the single primary label (reference :160-170)."""

    def __init__(self, ds, num_classes):
        self.ds = ds
        self.num_classes = num_classes

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        item = dict(self.ds[i])
        onehot = np.zeros(self.num_classes, np.float32)
        onehot[int(item["y"])] = 1.0
        item["y"] = onehot
        return item


def main(argv=None):
    from ..data import BucketBatcher, SeqLevelDataset, build_label2id, read_index_csv
    from ..data.batching import prefetch_to_device
    from ..device import resolve_device
    from ..models import FusionWithEmotionDecoder
    from ..parallel.train_step import (TrainConfig, create_train_state, make_eval_step,
                                       make_train_step)
    from ..utils import checkpoint as C
    from .common import (TrainLogWriter, dropout_seed, maybe_synthetic_iemocap, set_seed,
                         step_generator)

    args = parse_args(argv)
    device = resolve_device(args.device)
    set_seed(args.seed)
    args = maybe_synthetic_iemocap(args, seq_level=True)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    compute_dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    if device.type == "cuda":  # fp32 products stay fp32, as in the JAX package
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    rows, columns = read_index_csv(args.index_csv)
    # label2id from ALL rows, like the reference
    label2id = build_label2id(r[args.label_col] for r in rows)
    n_classes = len(label2id)
    mk = lambda split: SeqLevelDataset(  # noqa: E731
        [r for r in rows if r[args.split_col] == split], args.audio_dir, args.text_dir,
        uid_col=args.uid_col, label_col=args.label_col, label2id=label2id,
        max_len_audio=args.max_len_audio, max_len_text=args.max_len_text, columns=columns)
    train_ds, val_ds = mk("train"), mk("val")
    if args.loss_type == "multi_label":
        train_ds, val_ds = _OneHotDataset(train_ds, n_classes), _OneHotDataset(val_ds, n_classes)

    model = FusionWithEmotionDecoder(
        d_model=args.d_model, num_emotions=n_classes, n_heads=args.n_heads,
        num_layers_fusion=args.num_layers_fusion, num_layers_decoder=args.num_layers_decoder,
        beta_hidden=args.beta_hidden, dropout=args.dropout)
    model.init_weights(torch.Generator().manual_seed(args.seed))
    model.to(device)

    # uncapped (0): bucket at the corpus max (zero-length buckets would
    # silently train on empty sequences)
    la, lt = args.max_len_audio, args.max_len_text
    if not la or not lt:
        las, lts = zip(*((train_ds[i]["h_a"].shape[0], train_ds[i]["h_t"].shape[0])
                         for i in range(len(train_ds))))
        la, lt = la or max(las), lt or max(lts)
    train_loader = BucketBatcher(train_ds, args.batch_size, la=la, lt=lt,
                                 shuffle=True, seed=args.seed, drop_last=True)
    val_loader = BucketBatcher(val_ds, args.batch_size, la=la, lt=lt, drop_last=False)

    cfg = TrainConfig(
        loss_type=args.loss_type, beta_degeneracy=0.01,
        lr=args.lr, weight_decay=args.weight_decay, grad_clip=5.0,
        schedule="constant", total_steps=max(1, len(train_loader)) * args.epochs,
        compute_dtype=compute_dtype)
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
            y = batch["y"].cpu().numpy()[:n_valid]
            if args.loss_type == "single_label":
                preds = logits.argmax(-1).cpu().numpy()[:n_valid]
                correct += int((preds == y).sum())
            else:
                # reference multi-label accuracy: exact match at 0.5
                preds = (torch.sigmoid(logits).cpu().numpy()[:n_valid] > 0.5).astype(np.float32)
                correct += int((preds == y).all(axis=-1).sum())
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

    ckpt_path = out_dir / "best_fusion_seq_decoder.pt"
    C.save_torch_checkpoint(str(ckpt_path), {
        "model_state_dict": best_state, "args": vars(args), "label2id": label2id,
        "epoch": best_epoch, "val_acc": best_acc,
    })
    C.write_meta_json(str(out_dir / "meta.json"), {
        "model": "FusionWithEmotionDecoder", "level": "seq",
        "loss_type": args.loss_type, "best_val_acc": best_acc,
        "epoch": best_epoch, "label2id": label2id,
    })
    print(f"[Saved] {ckpt_path} (best val acc {best_acc:.4f})")
    return best_acc


if __name__ == "__main__":
    main()
