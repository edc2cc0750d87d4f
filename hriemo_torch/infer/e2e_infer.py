#!/usr/bin/env python3
"""End-to-end inference CLI: raw audio + transcripts -> emotion probabilities
(port of ``hriemo/infer/e2e_infer.py``).

One command drives the port's ``StreamingPipeline`` on the card: WavLM,
BERT, the fusion model and the decoder, audio and text length-bucketed, the
host feed overlapped with the device.

    python -m hriemo_torch.infer.e2e_infer --index_csv data/iemocap_index_splits.csv \\
        --wavlm_state_dict wavlm.pt --bert_state_dict bert.pt --vocab_file vocab.txt \\
        --fusion_ckpt runs/fusion/best_fusion_seq_decoder.pt --split test

Input: an IEMOCAP-style index CSV with ``audio_path`` and ``text`` columns
(``hriemo_torch.dataprep.iemocap_index``). Weights: local HF state dicts for
the frontends (``from_torch_state_dict``), a WordPiece ``--vocab_file``
(``dataprep.tokenization``) and a reference-layout fusion checkpoint, whose
``args`` override the fusion model's hyperparameters; ``--random_init``
validates the pipeline without weights. ``--int8`` serves the W8A8 tree,
``--amp_dtype off`` computes in fp32. Writes ``{split}_y_prob.npy``,
``{split}_beta_mean.npy`` and ``{split}_uids.txt``. ``--device`` is the
card unless ``cpu`` is asked for.
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

import numpy as np
import torch

DEFAULT_HOST_BATCH = 16     # the 'batch' scheduler's host batch
SEED = 0                    # --random_init weights


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--index_csv", type=str, required=True)
    ap.add_argument("--split", type=str, default=None,
                    help="filter the index's split column (optional)")
    ap.add_argument("--audio_col", type=str, default="audio_path")
    ap.add_argument("--text_col", type=str, default="text")
    ap.add_argument("--uid_col", type=str, default=None)
    ap.add_argument("--batch_size", type=int, default=None,
                    help="host batch size. Default: the bucket scheduler uses each "
                         "bucket's batch measured on the card (streaming."
                         "MEASURED_BUCKET_BATCH) uncapped; the 'batch' scheduler uses "
                         f"{DEFAULT_HOST_BATCH}. Pass explicitly to cap both.")
    ap.add_argument("--max_seconds", type=float, default=10.0)
    ap.add_argument("--bucket_seconds", type=float, nargs="+",
                    default=[1.25, 1.875, 2.5, 3.125, 3.75, 4.375, 5.0,
                             5.625, 6.25, 6.875, 7.5, 8.125, 8.75, 10.0])
    ap.add_argument("--max_tokens", type=int, default=128)
    ap.add_argument("--text_bucket_tokens", type=int, nargs="*",
                    default=[8, 12, 16, 20, 24, 32, 64],
                    help="pad each flush's tokens to the smallest of these buckets covering "
                         "its longest text (output-exact); pass no values to always pad "
                         "to --max_tokens")
    # weights
    ap.add_argument("--wavlm_state_dict", type=str, default=None)
    ap.add_argument("--bert_state_dict", type=str, default=None)
    ap.add_argument("--vocab_file", type=str, default=None)
    ap.add_argument("--fusion_ckpt", type=str, default=None,
                    help="reference-layout best_*.pt for the fusion stack")
    ap.add_argument("--num_emotions", type=int, default=4)
    ap.add_argument("--random_init", action="store_true")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--amp_dtype", type=str, default="bf16", choices=["bf16", "off"])
    ap.add_argument("--fast_gelu", action="store_true",
                    help="tanh-approximate GELU in WavLM and BERT")
    ap.add_argument("--multi_label", action="store_true")
    ap.add_argument("--allow_hash_tokenizer", action="store_true",
                    help="override the quality gate: run pretrained weights "
                         "with the validation-only hash tokenizer")
    ap.add_argument("--int8", action="store_true",
                    help="W8A8 int8 serving (frontends and fusion stack through the int8 "
                         "kernels)")
    ap.add_argument("--scheduler", choices=["bucket", "batch"], default="bucket",
                    help="'bucket' (default) regroups clips into per-length-bucket queues; "
                         "'batch' keeps fixed arrival-order host batches")
    ap.add_argument("--out_dir", type=str, default="outputs/e2e_infer")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    return ap.parse_args(argv)


def fusion_model(args, d_model: int):
    """The fusion model: ``--fusion_ckpt``'s weights, its ``args`` overriding
    the hyperparameters (``hriemo/infer/e2e_infer.py:125-138``), else random
    weights from ``SEED``."""
    from ..models import FusionWithEmotionDecoder
    from ..utils.checkpoint import load_torch_checkpoint

    if not args.fusion_ckpt:
        model = FusionWithEmotionDecoder(
            d_model=d_model, num_emotions=args.num_emotions, n_heads=4 if args.tiny else 8,
            num_layers_fusion=2, num_layers_decoder=2, beta_hidden=max(16, d_model // 3),
            dropout=0.1)
        model.init_weights(torch.Generator().manual_seed(SEED))
        return model
    ckpt = load_torch_checkpoint(args.fusion_ckpt)
    ck = ckpt.get("args", {})
    model = FusionWithEmotionDecoder(
        d_model=ck.get("d_model", d_model),
        num_emotions=len(ckpt.get("emo_cols", [])) or args.num_emotions,
        n_heads=ck.get("n_heads", 8), num_layers_fusion=ck.get("num_layers_fusion", 2),
        num_layers_decoder=ck.get("num_layers_decoder", 2),
        beta_hidden=ck.get("beta_hidden", 256), dropout=ck.get("dropout", 0.1))
    model.load_state_dict(ckpt["model_state_dict"], strict=True)
    return model


def main(argv=None, use_kernels: bool = True, cuda_graphs: bool | None = None):
    """Runs the CLI; ``use_kernels=False`` serves through every kernel's plain
    PyTorch version instead (the reference a kernel run is held against);
    ``cuda_graphs=False`` serves eagerly on the card, where the kernels'
    launch counters count every forward. Returns the output directory."""
    from ..data.datasets import read_index_csv, resolve_uid_col
    from ..dataprep.audio import prepare_waveform
    from ..dataprep.extract_iemocap import load_frontend, text_tokenizer
    from ..device import resolve_device
    from ..frontends import BertConfig, BertEncoder, WavLMConfig, WavLMEncoder
    from .streaming import MEASURED_BUCKET_BATCH, StreamingPipeline

    args = parse_args(argv)
    device = resolve_device(args.device)
    wcfg = WavLMConfig.tiny() if args.tiny else WavLMConfig.base_plus()
    bcfg = BertConfig.tiny() if args.tiny else BertConfig.base_uncased()
    # --tiny's BERT has fewer position embeddings than the default --max_tokens
    args.max_tokens = min(args.max_tokens, bcfg.max_position_embeddings)
    if args.fast_gelu:
        wcfg = dataclasses.replace(wcfg, fast_gelu=True)
        bcfg = dataclasses.replace(bcfg, fast_gelu=True)
    wavlm = load_frontend(WavLMEncoder(wcfg), args.wavlm_state_dict, args.random_init,
                          "wavlm_state_dict")
    bert = load_frontend(BertEncoder(bcfg), args.bert_state_dict, args.random_init,
                         "bert_state_dict")
    if bcfg.hidden_size != wcfg.hidden_size:
        raise SystemExit("[e2e] the frontends' hidden sizes differ")
    fusion = fusion_model(args, wcfg.hidden_size)
    tokenizer = text_tokenizer(args, bcfg.vocab_size, "e2e", pretrained=not args.random_init)

    pipe = StreamingPipeline(
        wavlm, bert, fusion, tokenizer=tokenizer, max_seconds=args.max_seconds,
        max_tokens=args.max_tokens,
        compute_dtype=torch.bfloat16 if args.amp_dtype == "bf16" else torch.float32,
        multi_label=args.multi_label, bucket_seconds=tuple(args.bucket_seconds),
        int8_frontends=args.int8, text_bucket_tokens=tuple(args.text_bucket_tokens),
        device=device, use_kernels=use_kernels, cuda_graphs=cuda_graphs)

    rows, columns = read_index_csv(args.index_csv)
    if args.split and "split" in columns:
        rows = [r for r in rows if r["split"] == args.split]
    uid_col = resolve_uid_col(columns, args.uid_col)

    def clip(r):
        wav, _ = prepare_waveform(r[args.audio_col], pad=False, max_seconds=args.max_seconds)
        return wav, str(r[args.text_col]), str(r[uid_col])

    if args.scheduler == "bucket":
        # an explicit --batch_size caps the measured batches, as in JAX
        batch = {} if not args.batch_size else dict(
            bucket_batch={sec: min(b, args.batch_size) for sec, b in MEASURED_BUCKET_BATCH.items()},
            default_batch=args.batch_size)
        stream = pipe.stream_bucketed(map(clip, rows), **batch)
    else:
        host_bs = args.batch_size or DEFAULT_HOST_BATCH
        stream = pipe.stream(list(zip(*map(clip, rows[i:i + host_bs])))
                             for i in range(0, len(rows), host_bs))

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    all_probs, all_uids, all_betas = [], [], []
    for probs, beta, uids in stream:
        all_probs.append(probs)
        all_betas.append(beta.reshape(len(uids), -1).mean(axis=1))
        all_uids.extend(uids)
    probs = np.concatenate(all_probs) if all_probs else np.zeros((0, args.num_emotions))
    betas = np.concatenate(all_betas) if all_betas else np.zeros((0,))
    split = args.split or "all"
    np.save(out_dir / f"{split}_y_prob.npy", probs)
    np.save(out_dir / f"{split}_beta_mean.npy", betas)
    with open(out_dir / f"{split}_uids.txt", "w") as f:
        f.write("\n".join(all_uids))
    print(f"[e2e] {len(all_uids)} utterances -> {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
