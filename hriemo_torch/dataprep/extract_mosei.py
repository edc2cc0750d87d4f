#!/usr/bin/env python3
"""MOSEI feature extraction from ``.csd`` computational sequences (port of
``hriemo/dataprep/extract_mosei.py``, without pandas; reference:
scripts/mosei_feature_extraction_seq_level/extract_{audio,text}_feats_from_csd.py).

Behavioral contract, the JAX CLI's:
  * audio: COVAREP frames sliced per segment by its label interval (a
    frame is kept if its center lies in ``[seg_start, seg_end]``, else any
    frame that overlaps it); NaN/Inf -> 0; saved as ``hidden [L, 74]`` and
    an all-ones mask;
  * text: timestamped word vectors (300-d GloVe) sliced the same way;
  * segments of videos missing from the ``.csd`` or shorter than
    ``--min_frames`` are skipped; ``meta.json`` gives ``hidden_dim``.

A host job: it reads and slices precomputed sequences, no device work.

    python -m hriemo_torch.dataprep.extract_mosei --modality audio \\
        --feats_csd CMU_MOSEI_COVAREP.csd --index_csv data/mosei_index_splits.csv \\
        --out_dir features/mosei/seq_level/audio
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from .mosei_csd import CsdFile, slice_by_interval


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--modality", choices=["audio", "text"], required=True)
    ap.add_argument("--feats_csd", type=str, required=True,
                    help="COVAREP .csd (audio) or word-vectors .csd (text)")
    ap.add_argument("--index_csv", type=str, required=True)
    ap.add_argument("--out_dir", type=str, required=True)
    ap.add_argument("--fmt", choices=["npz", "pt"], default="npz")
    ap.add_argument("--min_frames", type=int, default=1,
                    help="skip segments with fewer frames")
    return ap.parse_args(argv)


def main(argv=None):
    from ..data.datasets import read_index_csv
    from ..data.feature_store import save_feature, write_meta

    args = parse_args(argv)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    rows, _ = read_index_csv(args.index_csv)
    csd = CsdFile(args.feats_csd)
    available = set(csd.keys())

    n_done, n_skipped, dim = 0, 0, None
    cache_vid, cache = None, None
    for row in rows:
        vid = str(row["video_id"])
        if vid not in available:
            n_skipped += 1
            continue
        if vid != cache_vid:
            cache = (csd.features(vid), csd.intervals(vid))
            cache_vid = vid
        feats, intervals = cache
        seg = slice_by_interval(feats, intervals, float(row["t_start"]), float(row["t_end"]))
        if seg.shape[0] < args.min_frames:
            n_skipped += 1
            continue
        dim = seg.shape[1]
        save_feature(out_dir / f"{row['uid']}.{args.fmt}", seg, np.ones(seg.shape[0], np.int64))
        n_done += 1

    csd.close()
    if n_done == 0:
        raise SystemExit(f"[extract] no segments extracted ({n_skipped} skipped): do the "
                         "index CSV's video_ids match the .csd keys?")
    write_meta(out_dir, hidden_dim=dim, model=f"csd-{args.modality}", level="seq",
               count=n_done)
    print(f"[extract] {n_done} {args.modality} features -> {out_dir} ({n_skipped} skipped)")
    return out_dir


if __name__ == "__main__":
    main()
