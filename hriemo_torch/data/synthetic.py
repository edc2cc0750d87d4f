"""Synthetic corpora: small feature stores and index CSVs (port of
``hriemo/data/synthetic.py``). The same seed gives the same arrays and the
same CSV text as the JAX package's generators; the CSV is written in
pandas' ``to_csv(index=False)`` format without pandas. Labels carry a
planted signal, so a smoke run can learn.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

from .feature_store import save_feature, write_meta

MOSEI_EMO_COLS = ["emo_happy", "emo_sad", "emo_anger", "emo_fear", "emo_disgust", "emo_surprise"]
IEMOCAP_LABELS = ["angry", "excited", "frustrated", "happy", "neutral", "sad"]


def _write_csv(path: Path, rows: list[dict]) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(list(rows[0]))
        for r in rows:
            w.writerow(list(r.values()))


def _split(i: int, n: int) -> str:
    return "train" if i < int(0.7 * n) else ("val" if i < int(0.85 * n) else "test")


def make_synthetic_mosei(root, n: int = 32, d_audio: int = 74, d_text: int = 300,
                         max_la: int = 40, max_lt: int = 16, seed: int = 0, fmt: str = "npz"):
    """``features/{audio,text}/{uid}.<fmt>`` + ``mosei_index_splits.csv``.
    Returns ``(csv_path, audio_dir, text_dir)``."""
    root = Path(root)
    audio_dir, text_dir = root / "features" / "audio", root / "features" / "text"
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((d_audio + d_text, len(MOSEI_EMO_COLS))) * 0.5
    rows = []
    for i in range(n):
        uid = f"vid{i // 4}_{i % 4}"
        la = int(rng.integers(max_la // 2, max_la + 1))
        lt = int(rng.integers(max_lt // 2, max_lt + 1))
        h_a = rng.standard_normal((la, d_audio)).astype(np.float32)
        h_t = rng.standard_normal((lt, d_text)).astype(np.float32)
        save_feature(audio_dir / f"{uid}.{fmt}", h_a, np.ones(la, np.int64))
        save_feature(text_dir / f"{uid}.{fmt}", h_t, np.ones(lt, np.int64))
        pooled = np.concatenate([h_a.mean(0), h_t.mean(0)])
        y = np.clip(pooled @ w + rng.standard_normal(len(MOSEI_EMO_COLS)) * 0.1, -1, 3)
        row = {"uid": uid, "video_id": uid.split("_")[0], "split": _split(i, n)}
        row.update({c: float(v) for c, v in zip(MOSEI_EMO_COLS, y)})
        rows.append(row)
    write_meta(audio_dir, hidden_dim=d_audio, model="synthetic-covarep", level="seq")
    write_meta(text_dir, hidden_dim=d_text, model="synthetic-glove", level="seq")
    csv_path = root / "mosei_index_splits.csv"
    _write_csv(csv_path, rows)
    return csv_path, audio_dir, text_dir


def make_synthetic_iemocap(root, n: int = 32, d: int = 768, seq_level: bool = False,
                           max_la: int = 40, max_lt: int = 16, seed: int = 0, fmt: str = "npz"):
    """IEMOCAP-style corpus: one label column, utter- or seq-level features
    around a centroid per class. Returns ``(csv_path, audio_dir, text_dir)``."""
    root = Path(root)
    audio_dir, text_dir = root / "features" / "audio", root / "features" / "text"
    rng = np.random.default_rng(seed)
    centroids = rng.standard_normal((len(IEMOCAP_LABELS), d)) * 2.0
    rows = []
    for i in range(n):
        uid = f"Ses0{i % 5 + 1}F_impro0{i % 8 + 1}_F{i:03d}"
        cls = int(rng.integers(len(IEMOCAP_LABELS)))
        if seq_level:
            la = int(rng.integers(max_la // 2, max_la + 1))
            lt = int(rng.integers(max_lt // 2, max_lt + 1))
            h_a = (centroids[cls] + rng.standard_normal((la, d))).astype(np.float32)
            h_t = (centroids[cls] + rng.standard_normal((lt, d))).astype(np.float32)
            save_feature(audio_dir / f"{uid}.{fmt}", h_a, np.ones(la, np.int64))
            save_feature(text_dir / f"{uid}.{fmt}", h_t, np.ones(lt, np.int64))
        else:
            h_a = (centroids[cls] + rng.standard_normal(d)).astype(np.float32)
            h_t = (centroids[cls] + rng.standard_normal(d)).astype(np.float32)
            if fmt == "pt":  # the reference's utter-level layout: a bare [d] tensor
                import torch

                audio_dir.mkdir(parents=True, exist_ok=True)
                text_dir.mkdir(parents=True, exist_ok=True)
                torch.save(torch.tensor(h_a), audio_dir / f"{uid}.pt")
                torch.save(torch.tensor(h_t), text_dir / f"{uid}.pt")
            else:
                save_feature(audio_dir / f"{uid}.{fmt}", h_a)
                save_feature(text_dir / f"{uid}.{fmt}", h_t)
        rows.append({"utter_id": uid, "label": IEMOCAP_LABELS[cls], "split": _split(i, n)})
    level = "seq" if seq_level else "utter"
    write_meta(audio_dir, hidden_dim=d, model="synthetic-wavlm", level=level)
    write_meta(text_dir, hidden_dim=d, model="synthetic-bert", level=level)
    csv_path = root / "iemocap_index_splits.csv"
    _write_csv(csv_path, rows)
    return csv_path, audio_dir, text_dir
