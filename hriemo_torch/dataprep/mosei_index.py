#!/usr/bin/env python3
"""MOSEI index builder (port of ``hriemo/dataprep/mosei_index.py``, without
pandas; reference: scripts/mosei_feature_extraction_seq_level/build_mosei_index_splits.py).

Behavioral contract, the JAX builder's:
  * labels come from ``CMU_MOSEI_Labels.csd``: each segment's label row is
    ``[sentiment, happy, sad, anger, fear, disgust, surprise]``;
  * uid = ``{video_id}_{segment_idx}``;
  * emotion columns keep the raw scale (values may be negative);
  * splits use the official standard folds (``standard_folds``: explicit
    ``--folds_json``, the packaged file, mmsdk, an SDK checkout). Without
    any, the builder fails unless ``--allow_nonstandard_split`` is passed,
    which takes a deterministic hash-by-video split and says so;
  * ``mosei_index_splits.csv`` has the JAX builder's columns, rows and
    formatting (pandas ``to_csv(index=False)``: floats as ``repr``, NaN as
    an empty field).

    python -m hriemo_torch.dataprep.mosei_index --labels_csd CMU_MOSEI_Labels.csd --out_dir data
"""

from __future__ import annotations

import argparse
import collections
import csv
import hashlib
import math
from pathlib import Path

import numpy as np

from .mosei_csd import CsdFile

EMO_COLS = ["emo_happy", "emo_sad", "emo_anger", "emo_fear", "emo_disgust", "emo_surprise"]
COLUMNS = ["uid", "video_id", "seg_idx", "t_start", "t_end", "sentiment", "split", *EMO_COLS]


def _hash_split(video_id: str) -> str:
    h = int(hashlib.sha1(video_id.encode()).hexdigest(), 16) % 100
    return "train" if h < 70 else ("val" if h < 85 else "test")


def build_rows(labels_csd: str | Path, folds: dict | None) -> list[dict]:
    csd = CsdFile(labels_csd)
    fold_of = {}
    if folds:
        for name, key in (("train", "train"), ("val", "valid"), ("test", "test")):
            for vid in folds.get(key, folds.get(name, [])):
                fold_of[vid] = name

    rows = []
    for vid in csd.keys():
        feats = csd.features(vid)       # [n_segments, 7]
        intervals = csd.intervals(vid)  # [n_segments, 2]
        for i in range(feats.shape[0]):
            row = feats[i]
            split = fold_of.get(vid) if folds else _hash_split(vid)
            if split is None:
                continue  # video not in the official folds
            entry = {"uid": f"{vid}_{i}", "video_id": vid, "seg_idx": i,
                     "t_start": float(intervals[i, 0]), "t_end": float(intervals[i, 1]),
                     "sentiment": float(row[0]), "split": split}
            for c, name in enumerate(EMO_COLS):
                entry[name] = float(np.nan_to_num(row[1 + c]))
            rows.append(entry)
    csd.close()
    return rows


def _field(v):
    """A value as pandas writes it: NaN as an empty field."""
    return "" if isinstance(v, float) and math.isnan(v) else v


def write_index(path: Path, rows: list[dict]) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(COLUMNS)
        for r in rows:
            w.writerow([_field(r[c]) for c in COLUMNS])


def main(argv=None):
    from .standard_folds import FoldsUnavailable, load_standard_folds

    ap = argparse.ArgumentParser()
    ap.add_argument("--labels_csd", type=str, required=True)
    ap.add_argument("--folds_json", type=str, default=None,
                    help="explicit folds JSON; default: packaged standard folds")
    ap.add_argument("--sdk_path", type=str, default=None,
                    help="CMU-MultimodalSDK checkout to parse folds from")
    ap.add_argument("--allow_nonstandard_split", action="store_true",
                    help="opt-in: deterministic hash-by-video split when the official "
                         "folds are unavailable (NOT comparable to published MOSEI numbers)")
    ap.add_argument("--out_dir", type=str, default="data")
    args = ap.parse_args(argv)

    try:
        folds = load_standard_folds(args.folds_json, sdk_path=args.sdk_path)
        print(f"[index] official standard folds: {({k: len(v) for k, v in folds.items()})}")
    except FoldsUnavailable as e:
        if not args.allow_nonstandard_split:
            raise SystemExit(f"[index] ERROR: {e}")
        folds = None
        print("[index] WARNING: using NON-STANDARD deterministic hash split "
              "(--allow_nonstandard_split). Split membership differs from the "
              "official CMU-MOSEI folds; numbers are not comparable.")

    rows = build_rows(args.labels_csd, folds)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_csv = out_dir / "mosei_index_splits.csv"
    write_index(out_csv, rows)
    print(f"[index] {len(rows)} segments from {len({r['video_id'] for r in rows})} videos")
    for split, n in collections.Counter(r["split"] for r in rows).most_common():
        print(f"  {split}: {n}")
    for c in EMO_COLS:
        vals = [r[c] for r in rows]
        if vals:
            print(f"  {c}: min={min(vals):.2f} max={max(vals):.2f}")
    return out_csv


if __name__ == "__main__":
    main()
