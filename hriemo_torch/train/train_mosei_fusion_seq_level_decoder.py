#!/usr/bin/env python3
"""MOSEI flagship trainer (port of
``hriemo/train/train_mosei_fusion_seq_level_decoder.py``; reference:
scripts/fusion/train_mosei_fusion_seq_level_decoder.py).

The JAX CLI's flags and outputs, plus ``--device`` (``cuda`` by default;
raises without a card, never falls back to the CPU): per-class
``pos_weight`` BCE from the train split, linear warmup then cosine decay,
gradient accumulation, the beta-entropy regularizer, ``clamp(y, 0, 3) / 3``
targets, center-crop caps, the non-finite-step skip, micro/macro F1 and
macro AUC with truth binarised at > 0, per-class threshold calibration,
``--select_by``, and ``best_mosei_fusion_decoder.pt`` in the reference
layout (state dict, args, emo_cols, metrics, optional calibrated
thresholds), ``meta.json`` and ``outputs/train_log.csv``. bf16 compute over
fp32 master parameters by default.

``--resume`` and ``--native_ckpt`` keep ``out_dir/resume/{state,
best_params, meta.json}`` after every epoch (``utils/checkpoint.py``); a
``--resume`` run restores them and goes on at the next epoch with the best
metric and its pack carried across. As in JAX, the batcher's shuffle epoch
starts at 0 again, so a resumed run does not replay an uninterrupted one.
``--native_ckpt`` also writes the final parameters to ``out_dir/native_state``.
``--trace_dir`` traces the first epoch the run trains (``utils/profiling.py``).
``--native_loader`` assembles batches with the port's C++ loader
(``hriemo_torch/native.py``) and prints which loader ran.

``--n_data`` / ``--n_model`` train over the ``(data, model)`` mesh, as JAX
does whenever ``--n_data`` is given (even 1) or ``--n_model > 1``
(``hriemo_torch/parallel``). Outside torchrun the CLI starts the
``n_data x n_model`` ranks itself (``parallel/launch.py``; ``--n_data``
defaults to the cards per model group, 1 on the CPU); under torchrun it is
one of the launcher's ranks and ``--n_data`` defaults to ``world //
n_model``. Every rank builds the same global batch from the same shuffle and
keeps its block, so the run trains as the single-device one on the same
batches. Rank 0 alone prints, writes the log, the checkpoints, ``meta.json``
and the trace; checkpoints and the ``--resume`` state are saved whole, in
the single-device format, and a resumed mesh run restores whole, then
shards.

    python -m hriemo_torch.train.train_mosei_fusion_seq_level_decoder --synthetic 64
    python -m hriemo_torch.train.train_mosei_fusion_seq_level_decoder --synthetic 64 \
        --n_data 2 --n_model 2 --device cpu
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    # data paths
    ap.add_argument("--index_csv", type=str, default="data/mosei_index_splits.csv")
    ap.add_argument("--audio_dir", type=str, default="features/mosei/seq_level/audio")
    ap.add_argument("--text_dir", type=str, default="features/mosei/seq_level/text")
    # CSV columns
    ap.add_argument("--uid_col", type=str, default="uid")
    ap.add_argument("--video_col", type=str, default="video_id")
    ap.add_argument("--split_col", type=str, default="split")
    ap.add_argument("--emo_cols", nargs="+", default=[
        "emo_happy", "emo_sad", "emo_anger", "emo_fear", "emo_disgust", "emo_surprise"])
    # model config
    ap.add_argument("--d_model", type=int, default=256)
    ap.add_argument("--n_heads", type=int, default=4)
    ap.add_argument("--num_layers_fusion", type=int, default=2)
    ap.add_argument("--num_layers_decoder", type=int, default=2)
    ap.add_argument("--beta_hidden", type=int, default=128)
    ap.add_argument("--dropout", type=float, default=0.1)
    # training config
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--weight_decay", type=float, default=1e-2)
    ap.add_argument("--grad_accum", type=int, default=4)
    ap.add_argument("--warmup_ratio", type=float, default=0.1)
    ap.add_argument("--beta_entropy", type=float, default=1e-3)
    # sequence caps
    ap.add_argument("--max_len_audio", type=int, default=300)
    ap.add_argument("--max_len_text", type=int, default=128)
    # selection & IO
    ap.add_argument("--select_by", type=str, default="macro_auc",
                    choices=["macro_auc", "macro_f1", "calibrated_macro_f1"])
    ap.add_argument("--save_calibrated_ths", action="store_true")
    ap.add_argument("--num_workers", type=int, default=2)  # accepted for CLI compat
    ap.add_argument("--out_dir", type=str, default="runs/mosei_fusion_decoder")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--max_train_samples", type=int, default=None)
    ap.add_argument("--compute_dtype", type=str, default="bfloat16",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--n_data", type=int, default=None, help="mesh data-parallel ways")
    ap.add_argument("--n_model", type=int, default=1, help="mesh tensor-parallel ways")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="generate N synthetic samples instead of real data")
    ap.add_argument("--native_ckpt", action="store_true",
                    help="also write a resumable checkpoint with optimizer state")
    ap.add_argument("--resume", action="store_true",
                    help="resume from out_dir/resume (params+optimizer+epoch)")
    ap.add_argument("--trace_dir", type=str, default=None,
                    help="write a device trace of the first epoch run here")
    ap.add_argument("--native_loader", action="store_true",
                    help="use the C++ threaded batch assembler")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    return ap.parse_args(argv)


def evaluate(eval_step, loader, device, mesh=None):
    """Returns ``(loss, probs [N, C], y_raw [N, C], mean_beta)``. Under
    ``mesh`` each rank feeds its data block and gets the whole batch's
    outputs."""
    from ..data.batching import prefetch_to_device
    from ..parallel.mesh import shard_batch

    ys = []

    def feed():
        for batch in loader:
            ys.append(batch["y"][:batch["n_valid"]])
            yield batch if mesh is None else shard_batch(batch, mesh)

    losses, probs, betas = [], [], []
    for batch in prefetch_to_device(feed(), device):
        n_valid = batch["n_valid"]
        loss, logits, beta = eval_step(batch)
        losses.append(float(loss))
        probs.append(torch.sigmoid(logits).cpu().numpy()[:n_valid])
        betas.append(beta.cpu().numpy()[:n_valid])
    probs, ys = np.concatenate(probs), np.concatenate(ys)
    return float(np.mean(losses)), probs, ys, float(np.concatenate(betas).mean())


def main(argv=None):
    from ..device import resolve_device
    from ..parallel.launch import spawn, under_torchrun

    args = parse_args(argv)
    device = resolve_device(args.device)
    if not (args.n_data or args.n_model > 1):
        return train(args, device)
    world = 1  # under torchrun the launcher's world size holds
    if not under_torchrun():
        cards = torch.cuda.device_count() if device.type == "cuda" else 1
        world = (args.n_data or max(1, cards // args.n_model)) * args.n_model
    return spawn(_train_rank, world, device, args)[0]


def _train_rank(device, args):
    """One rank of a mesh run."""
    from ..parallel.mesh import make_mesh

    return train(args, device, make_mesh(args.n_data, args.n_model))


def train(args, device, mesh=None):
    """The run on ``device``; under ``mesh`` this rank's part of it.
    Returns the best value of ``--select_by``."""
    import torch.distributed as dist

    from ..data import BucketBatcher, SeqLevelDataset, read_index_csv
    from ..data.datasets import to_float
    from ..data.feature_store import hidden_dim_from_meta, read_meta
    from ..models import MoseiFusionWithEmotionDecoder
    from ..parallel.mesh import shard_batch
    from ..parallel.train_step import (TrainConfig, create_train_state, make_eval_step,
                                       make_train_step, shard_train_state)
    from ..utils import checkpoint as C
    from ..utils import metrics as M
    from ..utils.profiling import trace as profiler_trace
    from .common import (TrainLogWriter, dropout_seed, maybe_synthetic_mosei, set_seed,
                         step_generator)
    from ..data.batching import prefetch_to_device

    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)  # noqa: E731
    set_seed(args.seed)
    if lead:
        args = maybe_synthetic_mosei(args)
    if mesh is not None:  # the corpus rank 0 wrote
        shared = [args]
        dist.broadcast_object_list(shared, src=0)
        args = shared[0]
        say(f"[mesh] {mesh.shape}")
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    compute_dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    if device.type == "cuda":  # fp32 products stay fp32, as in the JAX package
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    rows, columns = read_index_csv(args.index_csv)
    train_rows = [r for r in rows if r[args.split_col] == "train"]
    val_rows = [r for r in rows if r[args.split_col] == "val"]
    if args.max_train_samples:
        train_rows = train_rows[: args.max_train_samples]
    mk_ds = lambda rs: SeqLevelDataset(  # noqa: E731
        rs, args.audio_dir, args.text_dir, uid_col=args.uid_col, emo_cols=args.emo_cols,
        max_len_audio=args.max_len_audio, max_len_text=args.max_len_text, columns=columns)
    train_ds, val_ds = mk_ds(train_rows), mk_ds(val_rows)

    # per-class pos_weight on the TRAIN split (reference :567-569)
    y_train = np.asarray([[to_float(r[c]) for c in args.emo_cols] for r in train_ds.rows],
                         np.float32).reshape(-1, len(args.emo_cols))
    pos_weight = M.pos_weights(M.binarize_truth(y_train))
    say("[pos_weight]", dict(zip(args.emo_cols, np.round(pos_weight, 2))))

    # feature dims from meta.json (reference :544-561)
    d_audio = hidden_dim_from_meta(read_meta(args.audio_dir))
    d_text = hidden_dim_from_meta(read_meta(args.text_dir))
    model = MoseiFusionWithEmotionDecoder(
        d_audio=d_audio, d_text=d_text, d_model=args.d_model,
        num_emotions=len(args.emo_cols), n_heads=args.n_heads,
        num_layers_fusion=args.num_layers_fusion, num_layers_decoder=args.num_layers_decoder,
        beta_hidden=args.beta_hidden, dropout=args.dropout)
    model.init_weights(torch.Generator().manual_seed(args.seed))
    model.to(device)

    # bucket lengths: the training caps (or the corpus max when uncapped)
    la, lt = args.max_len_audio, args.max_len_text
    if not la or not lt:
        las, lts = zip(*((it["h_a"].shape[0], it["h_t"].shape[0])
                         for it in (train_ds[i] for i in range(len(train_ds)))))
        la, lt = la or max(las), lt or max(lts)
    train_loader = BucketBatcher(train_ds, args.batch_size, la=la, lt=lt, shuffle=True,
                                 seed=args.seed, grad_accum=args.grad_accum, drop_last=True,
                                 native=args.native_loader)
    val_loader = BucketBatcher(val_ds, args.batch_size, la=la, lt=lt, drop_last=False,
                               native=args.native_loader)
    if args.native_loader:
        ran = "the C++ loader" if train_loader.native and val_loader.native else "the Python loader"
        say(f"[mosei] --native_loader: batches from {ran}")

    steps_per_epoch = max(1, len(train_loader))
    total_steps = steps_per_epoch * args.epochs
    cfg = TrainConfig(
        loss_type="multi_label", pos_weight=pos_weight,
        beta_entropy=args.beta_entropy, normalize_labels=True,
        lr=args.lr, weight_decay=args.weight_decay, grad_clip=5.0,
        grad_accum=args.grad_accum, warmup_steps=int(args.warmup_ratio * total_steps),
        total_steps=total_steps, compute_dtype=compute_dtype)
    state = create_train_state(model, cfg)
    base_seed = dropout_seed(args.seed)

    start_epoch, resume_meta = 1, {}
    resume_dir = out_dir / "resume"
    keep_resume = args.resume or args.native_ckpt
    if args.resume and (resume_dir / "state").exists():
        state = C.restore_native(str(resume_dir / "state"), like=state)
        resume_meta = json.loads((resume_dir / "meta.json").read_text())
        start_epoch = int(resume_meta.get("epoch", 0)) + 1
        say(f"[resume] restored step={int(state.step)}, continuing at epoch {start_epoch}")
    best_metric = resume_meta.get("best_metric", -1.0)
    best_state, best_pack = None, resume_meta.get("best_pack", {})
    if args.resume and (resume_dir / "best_params").exists():
        best_state = C.restore_native(str(resume_dir / "best_params"),
                                      like=C.state_dict_cpu(model))
    if mesh is not None:  # restored whole, now sharded
        state = shard_train_state(state, mesh)
    train_step = make_train_step(model, cfg, mesh)
    eval_step = make_eval_step(model, cfg, mesh)

    log = TrainLogWriter(out_dir / "outputs" / "train_log.csv",
                         ["epoch", "train_loss", "val_loss", "val_auc", "mean_beta",
                          "val_macro_f1", "val_cal_macro_f1", "epoch_time_s"]) if lead else None
    shard = (lambda b: b) if mesh is None else (  # noqa: E731
        lambda b: shard_batch(b, mesh, args.grad_accum))
    for epoch in range(start_epoch, args.epochs + 1):
        t0 = time.time()
        tr_losses, tr_betas = [], []
        trace_dir = args.trace_dir if epoch == start_epoch and lead else None
        with profiler_trace(trace_dir):
            for i, batch in enumerate(prefetch_to_device(map(shard, train_loader), device)):
                state, metrics = train_step(
                    state, batch, step_generator(base_seed, epoch * 100000 + i, device))
                tr_losses.append(metrics["loss"])
                tr_betas.append(metrics["mean_beta"])
        mean = lambda ts: float(np.mean(torch.stack(ts).double().cpu().numpy())) if ts else 0.0  # noqa: E731
        tr_loss, tr_beta = mean(tr_losses), mean(tr_betas)

        va_loss, probs, ys, va_beta = evaluate(eval_step, val_loader, device, mesh)
        y_bin = M.binarize_truth(ys)
        va_micro = M.micro_f1(y_bin, (probs >= 0.5).astype(int))
        va_macro = M.macro_f1(y_bin, (probs >= 0.5).astype(int))
        va_auc = M.macro_auc(y_bin, probs)
        cal_ths, cal_f1 = M.calibrate_thresholds(y_bin, probs)
        va_cal_macro = float(np.mean(cal_f1))
        dt = time.time() - t0

        say(f"=== Epoch {epoch}/{args.epochs} ({dt:.1f}s) ===")
        say(f"Train Loss: {tr_loss:.4f} | Mean β: {tr_beta:.3f}  ||  "
            f"Val Loss: {va_loss:.4f} | F1 micro/macro: {va_micro:.3f}/{va_macro:.3f} | "
            f"AUC macro: {va_auc:.3f} | cal-F1 macro: {va_cal_macro:.3f} | Mean β: {va_beta:.3f}")
        if lead:
            log.append(epoch=epoch, train_loss=tr_loss, val_loss=va_loss,
                       val_auc=va_auc, mean_beta=va_beta, val_macro_f1=va_macro,
                       val_cal_macro_f1=va_cal_macro, epoch_time_s=round(dt, 2))

        current = {"macro_auc": va_auc, "macro_f1": va_macro,
                   "calibrated_macro_f1": va_cal_macro}[args.select_by]
        if np.isnan(current):
            current = -1.0
        # every rank reads the same gathered outputs, so takes the same branch
        if current > best_metric:
            best_metric = current
            best_state = C.state_dict_cpu(model, mesh)
            best_pack = {
                "epoch": epoch, "val_macro_auc": va_auc, "val_macro_f1": va_macro,
                "val_calibrated_macro_f1": va_cal_macro,
                "val_calibrated_thresholds": cal_ths.tolist(),
            }
            if keep_resume:
                C.save_native(str(resume_dir / "best_params"), best_state, mesh)
        if keep_resume:
            C.save_native(str(resume_dir / "state"), state, mesh)
            if lead:
                (resume_dir / "meta.json").write_text(json.dumps({
                    "epoch": epoch, "best_metric": best_metric, "best_pack": best_pack}))
    if best_state is None:  # no epoch ran, or resumed past --epochs with no stored best
        best_state = C.state_dict_cpu(model, mesh)
    final_state = C.state_dict_cpu(model, mesh) if args.native_ckpt else None
    if not lead:
        return best_metric

    # checkpoint in the reference layout (reference :616-642)
    ckpt = {
        "model_state_dict": best_state,
        "args": vars(args),
        "emo_cols": args.emo_cols,
        **{k: v for k, v in best_pack.items() if k != "val_calibrated_thresholds"},
    }
    if args.save_calibrated_ths:
        ckpt["val_calibrated_thresholds"] = best_pack.get("val_calibrated_thresholds")
    ckpt_path = out_dir / "best_mosei_fusion_decoder.pt"
    C.save_torch_checkpoint(str(ckpt_path), ckpt)
    C.write_meta_json(str(out_dir / "meta.json"), {
        "model": "MoseiFusionWithEmotionDecoder",
        "select_by": args.select_by, "best_metric": best_metric, **best_pack,
    })
    if args.native_ckpt:
        C.save_native(str(out_dir / "native_state"), final_state)
    print(f"[Saved] {ckpt_path} (best {args.select_by}={best_metric:.4f})")
    return best_metric


if __name__ == "__main__":
    main()
