#!/usr/bin/env python3
"""Feature-store integrity checks and length statistics (port of
``hriemo/dataprep/integrity.py``, without pandas).

  * :func:`check_integrity`: ID-set equality between the audio and text
    feature directories and the index CSV, NaN/Inf scan, shape sampling;
  * :func:`analyze_lengths`: mean / median / 95th percentile / max of the
    sequence lengths -> ``length_stats.csv``.

    python -m hriemo_torch.dataprep.integrity check --index_csv I --audio_dir A --text_dir T
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path

import numpy as np

from ..data.feature_store import load_feature

EXTS = (".npz", ".pt", ".pth", ".npy")


def resolve_uid_col(columns, uid_col: str | None = None) -> str:
    """``hriemo/data/datasets.py::resolve_uid_col`` over a list of column
    names."""
    if uid_col and uid_col in columns:
        return uid_col
    for cand in ("utter_id", "uid"):
        if cand in columns:
            return cand
    raise KeyError(f"No uid column in index CSV: {list(columns)}")


def feature_ids(feat_dir: str | Path) -> set[str]:
    return {p.stem for p in Path(feat_dir).iterdir()
            if p.suffix in EXTS}


def check_integrity(index_csv: str, audio_dir: str, text_dir: str,
                    uid_col: str | None = None, sample: int = 50) -> dict:
    with open(index_csv, newline="") as f:
        reader = csv.DictReader(f)
        rows = list(reader)
    uid_col = resolve_uid_col(reader.fieldnames or [], uid_col)
    csv_ids = {r[uid_col] for r in rows}
    a_ids, t_ids = feature_ids(audio_dir), feature_ids(text_dir)

    report = {
        "csv_count": len(csv_ids),
        "audio_count": len(a_ids),
        "text_count": len(t_ids),
        "audio_minus_text": len(a_ids - t_ids),
        "text_minus_audio": len(t_ids - a_ids),
        "csv_missing_audio": len(csv_ids - a_ids),
        "csv_missing_text": len(csv_ids - t_ids),
        "nan_files": [],
        "shapes": {},
    }

    both = sorted(a_ids & t_ids & csv_ids)
    rng = np.random.default_rng(0)
    picks = rng.choice(both, size=min(sample, len(both)), replace=False) if both else []
    for which, d in (("audio", Path(audio_dir)), ("text", Path(text_dir))):
        dims = set()
        lens = []
        for uid in picks:
            for ext in EXTS:
                p = d / f"{uid}{ext}"
                if p.is_file():
                    break
            hidden, mask = load_feature(p)
            if not np.isfinite(hidden).all():
                report["nan_files"].append(str(p))
            dims.add(hidden.shape[-1])
            if hidden.ndim == 2:
                lens.append(hidden.shape[0])
        report["shapes"][which] = {"dims": sorted(dims),
                                   "len_mean": float(np.mean(lens)) if lens else None}
    report["ok"] = (
        report["audio_minus_text"] == 0
        and report["text_minus_audio"] == 0
        and not report["nan_files"]
    )
    return report


def analyze_lengths(feat_dir: str, out_csv: str | None = None) -> dict:
    lens = []
    for p in sorted(Path(feat_dir).iterdir()):
        if p.suffix not in EXTS or p.name == "meta.json":
            continue
        hidden, _ = load_feature(p)
        if hidden.ndim == 2:
            lens.append(hidden.shape[0])
    lens = np.asarray(lens)
    stats = {
        "count": int(lens.size),
        "mean": float(lens.mean()) if lens.size else 0.0,
        "median": float(np.median(lens)) if lens.size else 0.0,
        "p95": float(np.percentile(lens, 95)) if lens.size else 0.0,
        "max": int(lens.max()) if lens.size else 0,
    }
    if out_csv:
        Path(out_csv).parent.mkdir(parents=True, exist_ok=True)
        with open(out_csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(stats))
            w.writeheader()
            w.writerow(stats)
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("check")
    c.add_argument("--index_csv", required=True)
    c.add_argument("--audio_dir", required=True)
    c.add_argument("--text_dir", required=True)
    l = sub.add_parser("lengths")
    l.add_argument("--feat_dir", required=True)
    l.add_argument("--out_csv", default="data/length_stats.csv")
    args = ap.parse_args(argv)

    if args.cmd == "check":
        report = check_integrity(args.index_csv, args.audio_dir, args.text_dir)
        for k, v in report.items():
            print(f"  {k}: {v}")
        if not report["ok"]:
            raise SystemExit("[integrity] FAILED")
        print("[integrity] OK")
        return report
    stats = analyze_lengths(args.feat_dir, args.out_csv)
    print(f"[lengths] {stats}")
    return stats


if __name__ == "__main__":
    main()
