#!/usr/bin/env python3
"""IEMOCAP feature extraction on the card (port of
``hriemo/dataprep/extract_iemocap.py``): WavLM or BERT over the index CSV,
one feature file per utterance.

    python -m hriemo_torch.dataprep.extract_iemocap \\
        --modality audio --level seq --index_csv data/iemocap_index_splits.csv \\
        --random_init --out_dir features/seq_level/audio

Behavioral contract, the JAX CLI's:
  * audio: mono -> 16 kHz -> peak-norm -> ``max_seconds`` cap, padded; WavLM
    last_hidden_state per frame; utter level: mask-weighted time mean-pool;
  * text: ``max_len_text`` tokens; BERT hidden states + attention mask (seq)
    or the masked mean-pool (utter);
  * artifacts: one file per uid (``{"hidden", "attention_mask"}`` for seq, a
    bare vector for utter) + a ``meta.json`` with ``hidden_dim``, readable
    by the JAX package's ``load_feature`` / ``load_utter_feature``.

Utterances run in fixed-size batches padded to ``max_seconds``; the host
feed overlaps the device: each batch goes through pinned memory with a
non-blocking copy, and the previous batch's features are read back and
written while the next one runs. ``--device`` is the card unless ``cpu``
is asked for; ``--compute_dtype float32`` keeps matmuls and cuDNN convs in
full fp32 (no TF32).

Weights: ``--wavlm_state_dict`` / ``--bert_state_dict`` (local HF state
dict files, through the frontends' ``from_torch_state_dict``) or
``--random_init`` (random weights from a fixed seed; features are
meaningless). Text goes through ``--vocab_file`` (a local WordPiece
``vocab.txt``, ``dataprep.tokenization``), else through the
validation-only hash tokenizer, which pretrained BERT weights refuse
unless ``--allow_hash_tokenizer`` is given.
"""

from __future__ import annotations

import argparse
import copy
import time
from pathlib import Path

import numpy as np
import torch

from ..data.feature_store import save_feature, write_meta
from ..device import resolve_device
from ..frontends import BertConfig, BertEncoder, WavLMConfig, WavLMEncoder
from ..nn.layers import set_use_kernels
from .audio import TARGET_SR, prepare_waveform
from .iemocap_index import read_csv
from .tokenization import WordPieceTokenizer

SEED = 0  # --random_init weights


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--modality", choices=["audio", "text"], required=True)
    ap.add_argument("--level", choices=["utter", "seq"], default="seq")
    ap.add_argument("--index_csv", type=str, required=True)
    ap.add_argument("--out_dir", type=str, required=True)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--max_seconds", type=float, default=10.0)
    ap.add_argument("--max_len_text", type=int, default=128)
    ap.add_argument("--fmt", choices=["npz", "pt"], default="npz")
    # weights
    ap.add_argument("--wavlm_state_dict", type=str, default=None)
    ap.add_argument("--bert_state_dict", type=str, default=None)
    ap.add_argument("--vocab_file", type=str, default=None,
                    help="local WordPiece vocab.txt for the tokenizer")
    ap.add_argument("--random_init", action="store_true",
                    help="run with random weights (pipeline validation only)")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny model configs (tests)")
    ap.add_argument("--compute_dtype", choices=["float32", "bfloat16"], default="float32")
    ap.add_argument("--allow_hash_tokenizer", action="store_true",
                    help="override the quality gate: allow pretrained BERT "
                         "weights with the validation-only hash tokenizer")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    return ap.parse_args(argv)


def load_state_dict_file(path) -> dict:
    """A torch state dict file, or a checkpoint holding one under
    ``model_state_dict`` (``hriemo/dataprep/extract_iemocap.py:70-74``)."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    return obj["model_state_dict"] if isinstance(obj, dict) and "model_state_dict" in obj \
        else obj


def _batched(seq, n):
    for i in range(0, len(seq), n):
        yield seq[i: i + n]


def load_frontend(module, state_dict_path, random_init: bool, flag: str):
    """``module`` with the weights of ``state_dict_path`` (an HF state dict)
    or, with ``random_init``, random weights from ``SEED``."""
    if state_dict_path:
        return module.from_torch_state_dict(load_state_dict_file(state_dict_path))
    if not random_init:
        raise SystemExit(f"need --{flag} (or --random_init for validation)")
    module.init_weights(torch.Generator().manual_seed(SEED))
    return module


def text_tokenizer(args, vocab_size: int, tag: str, pretrained: bool):
    """The WordPiece tokenizer of ``--vocab_file``, else the hash tokenizer,
    which pretrained weights refuse unless ``--allow_hash_tokenizer`` is
    given (the JAX CLIs' quality gate: real weights with the hash tokenizer
    write features that look right and are not)."""
    if args.vocab_file:
        return WordPieceTokenizer(args.vocab_file)
    if pretrained and not args.allow_hash_tokenizer:
        raise SystemExit(
            f"[{tag}] refusing to run pretrained BERT weights with the hash tokenizer: pass "
            "--vocab_file (the real BERT vocab) or --allow_hash_tokenizer to override")
    print(f"[{tag}] WARNING: no --vocab_file; using a hash tokenizer (pipeline validation only)")
    return _HashTokenizer(vocab_size)


def _on_device(model, args, use_kernels: bool):
    """A copy of ``model`` in the compute dtype on the device (the caller's
    module is left as it is), and the device and dtype."""
    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    if device.type == "cuda" and dtype == torch.float32:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    m = copy.deepcopy(model).to(device, dtype).eval()
    return set_use_kernels(m, use_kernels), device, dtype


def _to_device(arr, device):
    t = torch.from_numpy(arr)
    return t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t


def extract_audio(args, rows, out_dir: Path, model=None, use_kernels: bool = True) -> dict:
    """WavLM features of ``rows`` (index CSV rows: ``utter_id``,
    ``audio_path``). ``model``: a port ``WavLMEncoder`` (default: the
    weights of ``--wavlm_state_dict`` or ``--random_init``). Returns
    ``count``, ``forwards`` and ``seconds`` (wall time of the batch loop)."""
    if model is None:
        model = load_frontend(WavLMEncoder(WavLMConfig.tiny() if args.tiny
                                           else WavLMConfig.base_plus()),
                              args.wavlm_state_dict, args.random_init, "wavlm_state_dict")
    model, device, dtype = _on_device(model, args, use_kernels)
    t_max = int(args.max_seconds * TARGET_SR)
    n_done = forwards = 0

    def flush(p):
        nonlocal n_done
        uids, (hidden, frame_mask) = p
        hidden = hidden.cpu().numpy()
        frame_mask = frame_mask.cpu().numpy()
        for j, uid in enumerate(uids):
            h = hidden[j]
            m = frame_mask[j]
            if args.level == "utter":
                # mask-weighted time mean-pool
                w = m.astype(np.float32)
                vec = (h * w[:, None]).sum(0) / max(w.sum(), 1.0)
                save_feature(out_dir / f"{uid}.{args.fmt}", vec)
            else:
                save_feature(out_dir / f"{uid}.{args.fmt}", h, m.astype(np.int64))
            n_done += 1

    t0 = time.perf_counter()
    pending = None  # (uids, device result) of the previous batch
    for chunk in _batched(rows, args.batch_size):
        wavs = np.zeros((args.batch_size, t_max), np.float32)
        masks = np.zeros((args.batch_size, t_max), np.int32)
        uids = []
        for j, row in enumerate(chunk):
            wav, n = prepare_waveform(row["audio_path"], pad=True,
                                      max_seconds=args.max_seconds)
            wavs[j, : len(wav)] = wav
            masks[j, :n] = 1
            uids.append(row["utter_id"])
        with torch.inference_mode():
            hidden, frame_mask = model(_to_device(wavs, device).to(dtype),
                                       _to_device(masks, device))
            result = (hidden.float(), frame_mask)
        forwards += 1
        if pending is not None:
            flush(pending)
        pending = (uids, result)
    if pending is not None:
        flush(pending)
    seconds = time.perf_counter() - t0

    write_meta(out_dir, hidden_dim=model.config.hidden_size,
               model="wavlm-torch", level=args.level, sample_rate=TARGET_SR,
               max_seconds=args.max_seconds, count=n_done)
    print(f"[extract] {n_done} audio features -> {out_dir}")
    return dict(count=n_done, forwards=forwards, seconds=seconds)


class _HashTokenizer:
    """The JAX CLI's validation-only tokenizer (whitespace split, Python's
    ``hash`` of each word, which is salted per process), HF call signature."""

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def __call__(self, texts, max_length, padding, truncation, return_tensors):
        ids = np.zeros((len(texts), max_length), np.int32)
        mask = np.zeros((len(texts), max_length), np.int32)
        for i, t in enumerate(texts):
            toks = [1] + [2 + (hash(w) % (self.vocab_size - 3)) for w in t.lower().split()]
            toks = toks[: max_length - 1] + [2]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def extract_text(args, rows, out_dir: Path, model=None, use_kernels: bool = True) -> dict:
    """BERT features of ``rows`` (``utter_id``, ``text``). ``model``: a port
    ``BertEncoder`` (default: the weights of ``--bert_state_dict`` or
    ``--random_init``)."""
    if model is None:
        model = load_frontend(BertEncoder(BertConfig.tiny() if args.tiny
                                          else BertConfig.base_uncased()),
                              args.bert_state_dict, args.random_init, "bert_state_dict")
    tokenizer = text_tokenizer(args, model.config.vocab_size, "extract",
                               bool(args.bert_state_dict))
    model, device, _ = _on_device(model, args, use_kernels)
    cfg = model.config
    max_len = args.max_len_text
    n_done = 0
    t0 = time.perf_counter()
    for chunk in _batched(rows, args.batch_size):
        texts = [str(r["text"]) for r in chunk]
        enc = tokenizer(texts, max_length=max_len, padding="max_length",
                        truncation=True, return_tensors="np")
        ids = np.zeros((args.batch_size, max_len), np.int64)
        mask = np.zeros((args.batch_size, max_len), np.int32)
        ids[: len(chunk)] = enc["input_ids"]
        mask[: len(chunk)] = enc["attention_mask"]
        with torch.inference_mode():
            seq, pooled = model(_to_device(ids, device), _to_device(mask, device))
            seq, pooled = seq.float().cpu().numpy(), pooled.float().cpu().numpy()
        for j, row in enumerate(chunk):
            if args.level == "utter":
                save_feature(out_dir / f"{row['utter_id']}.{args.fmt}", pooled[j])
            else:
                save_feature(out_dir / f"{row['utter_id']}.{args.fmt}", seq[j],
                             mask[j].astype(np.int64))
            n_done += 1
    seconds = time.perf_counter() - t0

    write_meta(out_dir, hidden_dim=cfg.hidden_size, model="bert-torch",
               level=args.level, max_len=max_len, count=n_done)
    print(f"[extract] {n_done} text features -> {out_dir}")
    return dict(count=n_done, seconds=seconds)


def main(argv=None):
    args = parse_args(argv)
    resolve_device(args.device)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rows = read_csv(args.index_csv)
    if args.modality == "audio":
        extract_audio(args, rows, out_dir)
    else:
        extract_text(args, rows, out_dir)
    return out_dir


if __name__ == "__main__":
    main()
