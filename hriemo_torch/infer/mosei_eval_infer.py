#!/usr/bin/env python3
"""MOSEI inference over a trained checkpoint (port of
``hriemo/infer/mosei_eval_infer.py``; reference:
scripts/infer/mosei_eval_infer.py).

    python -m hriemo_torch.infer.mosei_eval_infer --ckpt runs/mosei/best_mosei_fusion_decoder.pt \\
        --splits val test --dump_beta --dump_attn --out_dir outputs/mosei_infer

Artifacts per split, the JAX CLI's:
  * ``{split}_y_prob.npy``: sigmoid probabilities ``[N, C]``;
  * ``{split}_y_true.npy``: raw-scale labels ``[N, C]`` (when the index has
    labels);
  * ``--dump_beta``: ``{split}_beta_mean.npy``, beta reduced to one scalar
    per sample;
  * ``--dump_attn``: ``{split}_attentions.pt`` =
    ``{"encoder": [batch][layer]{4 maps}, "decoder": [batch][layer][B, E, L]}``,
    capped at ``--attn_max_samples``.

The model's hyperparameters are overridden from ``ckpt["args"]``
(``MODEL_ARG_KEYS``); feature dims come from each directory's
``meta.json``. Probabilities always come from the fast path, in the compute
dtype, so ``y_prob.npy`` is the same with and without ``--dump_attn``; the
attention dump runs a second forward on the uncast fp32 weights, with TF32
off on the card. ``--max_len_audio 0`` (uncapped) buckets each split at its
longest utterance, which from 1024 frames routes the audio self-attention
through ``flash_mha``, whose kernels take bf16, fp16 and fp32 (fp16 with the
bf16 numerics, as the TPU kernels run it). ``--device`` is the card unless
``cpu`` is asked for.
"""

from __future__ import annotations

import argparse
import copy
from pathlib import Path

import numpy as np
import torch

MODEL_ARG_KEYS = ("d_model", "n_heads", "num_layers_fusion", "num_layers_decoder",
                  "beta_hidden", "dropout", "max_len_audio", "max_len_text", "emo_cols")
DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16, "off": torch.float32}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", type=str, required=True)
    ap.add_argument("--index_csv", type=str, default="data/mosei_index_splits.csv")
    ap.add_argument("--audio_dir", type=str, default="features/mosei/seq_level/audio")
    ap.add_argument("--text_dir", type=str, default="features/mosei/seq_level/text")
    ap.add_argument("--uid_col", type=str, default=None)
    ap.add_argument("--split_col", type=str, default="split")
    ap.add_argument("--splits", nargs="+", default=["val", "test"])
    ap.add_argument("--emo_cols", nargs="+", default=[
        "emo_happy", "emo_sad", "emo_anger", "emo_fear", "emo_disgust", "emo_surprise"])
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--max_len_audio", type=int, default=300)
    ap.add_argument("--max_len_text", type=int, default=128)
    ap.add_argument("--d_model", type=int, default=256)
    ap.add_argument("--n_heads", type=int, default=4)
    ap.add_argument("--num_layers_fusion", type=int, default=2)
    ap.add_argument("--num_layers_decoder", type=int, default=2)
    ap.add_argument("--beta_hidden", type=int, default=128)
    ap.add_argument("--dropout", type=float, default=0.2)
    ap.add_argument("--dump_beta", action="store_true")
    ap.add_argument("--dump_attn", action="store_true")
    ap.add_argument("--attn_max_samples", type=int, default=16)
    ap.add_argument("--amp_dtype", type=str, default="bf16", choices=["bf16", "fp16", "off"])
    ap.add_argument("--out_dir", type=str, default="outputs/mosei_infer")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    return ap.parse_args(argv)


def run_split(model, ds, split, args, out_dir: Path, compute_dtype, device, use_kernels=True):
    """Writes one split's artifacts; returns its probabilities. ``model`` is
    the fp32 model on the CPU; ``use_kernels=False`` runs every kernel's
    plain version instead."""
    from ..data import BucketBatcher, prefetch_to_device
    from ..nn.layers import set_use_kernels

    # uncapped (max_len == 0): bucket at the split's true maximum length
    la = args.max_len_audio or max((ds[i]["h_a"].shape[0] for i in range(len(ds))), default=1)
    lt = args.max_len_text or max((ds[i]["h_t"].shape[0] for i in range(len(ds))), default=1)
    loader = BucketBatcher(ds, args.batch_size, la=la, lt=lt, drop_last=False)
    fast = set_use_kernels(copy.deepcopy(model).to(device, compute_dtype).eval(), use_kernels)
    full = set_use_kernels(copy.deepcopy(model).to(device).eval(), use_kernels) \
        if args.dump_attn else None

    probs, ys, betas = [], [], []
    attn = {"encoder": [], "decoder": []}
    n_attn = 0
    with torch.inference_mode():
        for batch in prefetch_to_device(iter(loader), device):
            n_valid = batch["n_valid"]
            h_a, h_t, mask_a, mask_t = (batch[k] for k in ("h_a", "h_t", "mask_a", "mask_t"))
            logits, beta, _ = fast(h_a.to(compute_dtype), h_t.to(compute_dtype), mask_a, mask_t)
            if args.dump_attn and n_attn < args.attn_max_samples:
                # the exported maps come from the fp32 weights
                _, _, _, pack = full(h_a, h_t, mask_a, mask_t, return_attention=True)
                take = min(n_valid, args.attn_max_samples - n_attn)
                attn["encoder"].append([{k: v[:take].cpu() for k, v in layer.items()}
                                        for layer in pack["encoder"]])
                attn["decoder"].append([m[:take].cpu() for m in pack["decoder"]])
                n_attn += take
            probs.append(torch.sigmoid(logits.float()).cpu().numpy()[:n_valid])
            if "y" in batch:
                ys.append(batch["y"].cpu().numpy()[:n_valid])
            betas.append(beta.float().cpu().numpy()[:n_valid].reshape(n_valid, -1).mean(axis=1))

    probs = np.concatenate(probs) if probs else np.zeros((0, len(args.emo_cols)))
    out_dir.mkdir(parents=True, exist_ok=True)
    np.save(out_dir / f"{split}_y_prob.npy", probs)
    if ys:
        np.save(out_dir / f"{split}_y_true.npy", np.concatenate(ys))
    if args.dump_beta:
        np.save(out_dir / f"{split}_beta_mean.npy", np.concatenate(betas))
    if args.dump_attn:
        torch.save(attn, out_dir / f"{split}_attentions.pt")
    print(f"[{split}] wrote {len(probs)} samples to {out_dir}")
    return probs


def main(argv=None, use_kernels: bool = True):
    """Runs the CLI; ``use_kernels=False`` runs every kernel's plain PyTorch
    version instead. Returns the output directory."""
    from ..data import SeqLevelDataset, read_index_csv
    from ..data.feature_store import hidden_dim_from_meta, read_meta
    from ..device import resolve_device
    from ..models import MoseiFusionWithEmotionDecoder
    from ..utils.checkpoint import load_torch_checkpoint

    args = parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":  # fp32 products stay fp32, as in the JAX package
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ckpt = load_torch_checkpoint(args.ckpt)
    ck_args = ckpt.get("args", {})
    for key in MODEL_ARG_KEYS:
        if ck_args.get(key) is not None:
            setattr(args, key, ck_args[key])

    model = MoseiFusionWithEmotionDecoder(
        d_audio=hidden_dim_from_meta(read_meta(args.audio_dir)),
        d_text=hidden_dim_from_meta(read_meta(args.text_dir)), d_model=args.d_model,
        num_emotions=len(args.emo_cols), n_heads=args.n_heads,
        num_layers_fusion=args.num_layers_fusion, num_layers_decoder=args.num_layers_decoder,
        beta_hidden=args.beta_hidden, dropout=args.dropout)
    model.load_state_dict(ckpt["model_state_dict"], strict=True)

    rows, columns = read_index_csv(args.index_csv)
    has_labels = all(c in columns for c in args.emo_cols)
    out_dir = Path(args.out_dir)
    for split in args.splits:
        ds = SeqLevelDataset(
            [r for r in rows if r[args.split_col] == split], args.audio_dir, args.text_dir,
            uid_col=args.uid_col, emo_cols=args.emo_cols if has_labels else None,
            max_len_audio=args.max_len_audio, max_len_text=args.max_len_text, columns=columns)
        run_split(model, ds, split, args, out_dir, DTYPES[args.amp_dtype], device, use_kernels)
    return out_dir


if __name__ == "__main__":
    main()
