"""Index-CSV datasets on the host (port of ``hriemo/data/datasets.py``,
seq and utter level, over CSV rows instead of a dataframe).

Reference semantics: rows missing either modality's feature file are
dropped with a count; the uid column is ``utter_id`` or ``uid``;
``label2id`` is built from the sorted unique labels; sequences longer than
``max_len`` are center-cropped and the crop resets the pad mask to
all-valid (a reference quirk, kept); NaN labels become 0.
"""

from __future__ import annotations

import csv
import math
from pathlib import Path

import numpy as np

from .feature_store import load_feature, load_utter_feature


def read_index_csv(path) -> tuple[list[dict], list[str]]:
    """An index CSV as ``(rows, columns)``, rows as dicts of strings."""
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        return list(reader), list(reader.fieldnames or [])


def to_float(s) -> float:
    """A CSV field as pandas reads a float column: empty -> NaN."""
    return math.nan if s is None or s == "" else float(s)


def crop_center(x: np.ndarray, max_len: int) -> np.ndarray:
    """Center-crop along axis 0 (reference: train_mosei_...py:178-183)."""
    if x.shape[0] <= max_len:
        return x
    start = (x.shape[0] - max_len) // 2
    return x[start: start + max_len]


def build_label2id(labels) -> dict:
    return {lab: i for i, lab in enumerate(sorted(set(map(str, labels))))}


def resolve_uid_col(columns, uid_col: str | None = None) -> str:
    if uid_col and uid_col in columns:
        return uid_col
    for cand in ("utter_id", "uid"):
        if cand in columns:
            return cand
    raise KeyError(f"No uid column in index CSV: {list(columns)}")


def _find_feat(feat_dir: Path, uid: str) -> Path | None:
    for ext in (".npz", ".pt", ".pth", ".npy"):
        p = feat_dir / f"{uid}{ext}"
        if p.is_file():
            return p
    return None


def _keep_rows_with_both(rows, uid_col, audio_dir: Path, text_dir: Path, verbose: bool):
    """The rows whose uid has a feature file in both directories, and their
    ``(audio, text)`` paths; the count of the others is printed."""
    kept, paths, missing = [], [], 0
    for row in rows:
        uid = str(row[uid_col])
        pa, pt = _find_feat(audio_dir, uid), _find_feat(text_dir, uid)
        if pa is not None and pt is not None:
            kept.append(row)
            paths.append((pa, pt))
        else:
            missing += 1
    if missing > 0 and verbose:
        print(f"[Dataset] Filtered out {missing} rows without both modalities.")
    return kept, paths


class SeqLevelDataset:
    """Two-modality sequence dataset over index rows. ``__getitem__`` returns
    numpy arrays: ``h_a [L_a, d_a]``, ``mask_a [L_a]`` bool (True = PAD),
    ``h_t``, ``mask_t``, ``y`` (float emotions or an int label) and ``uid``.
    ``columns`` (the CSV header) resolves the uid column when ``rows`` is
    empty."""

    def __init__(self, rows: list[dict], audio_dir, text_dir, uid_col: str | None = None,
                 emo_cols: list[str] | None = None, label_col: str | None = None,
                 label2id: dict | None = None, max_len_audio: int = 0, max_len_text: int = 0,
                 verbose: bool = True, columns=None):
        self.audio_dir, self.text_dir = Path(audio_dir), Path(text_dir)
        self.uid_col = resolve_uid_col(columns if columns is not None
                                       else (list(rows[0]) if rows else []), uid_col)
        self.emo_cols, self.label_col, self.label2id = emo_cols, label_col, label2id
        self.max_len_audio, self.max_len_text = max_len_audio, max_len_text
        self.rows, self._paths = _keep_rows_with_both(rows, self.uid_col, self.audio_dir,
                                                      self.text_dir, verbose)
        if verbose:
            print(f"[Dataset] Final size: {len(self.rows)} samples")

    def __len__(self):
        return len(self.rows)

    def _labels(self, row):
        if self.emo_cols is not None:
            y = np.asarray([to_float(row[c]) for c in self.emo_cols], dtype=np.float32)
            return np.nan_to_num(y, nan=0.0)
        if self.label_col is not None:
            lab = str(row[self.label_col])
            return np.int64(self.label2id[lab]) if self.label2id else lab
        return None

    def __getitem__(self, idx: int) -> dict:
        row = self.rows[idx]
        pa, pt = self._paths[idx]
        h_a, m_a = load_feature(pa)
        h_t, m_t = load_feature(pt)
        mask_a, mask_t = m_a == 0, m_t == 0  # True = PAD
        if self.max_len_audio > 0:
            h_a = crop_center(h_a, self.max_len_audio)
            mask_a = np.zeros(h_a.shape[0], dtype=bool)  # quirk: mask reset
        if self.max_len_text > 0:
            h_t = crop_center(h_t, self.max_len_text)
            mask_t = np.zeros(h_t.shape[0], dtype=bool)
        out = {"h_a": h_a, "mask_a": mask_a, "h_t": h_t, "mask_t": mask_t}
        y = self._labels(row)
        if y is not None:
            out["y"] = y
        out["uid"] = str(row[self.uid_col])
        return out


class UtterLevelDataset:
    """Utterance-level dataset: one ``[d]`` vector per modality and uid
    (reference: train_fusion_utter_level.py:164-198). ``__getitem__``
    returns ``h_a``, ``h_t``, ``y`` (the label's id) and ``uid``;
    ``label2id`` defaults to the sorted labels of the kept rows."""

    def __init__(self, rows: list[dict], audio_dir, text_dir, uid_col: str | None = None,
                 label_col: str = "label", label2id: dict | None = None,
                 verbose: bool = True, columns=None):
        self.audio_dir, self.text_dir = Path(audio_dir), Path(text_dir)
        self.uid_col = resolve_uid_col(columns if columns is not None
                                       else (list(rows[0]) if rows else []), uid_col)
        self.label_col = label_col
        self.rows, self._paths = _keep_rows_with_both(rows, self.uid_col, self.audio_dir,
                                                      self.text_dir, verbose)
        self.label2id = label2id or build_label2id(r[label_col] for r in self.rows)

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, idx: int) -> dict:
        row = self.rows[idx]
        pa, pt = self._paths[idx]
        return {"h_a": load_utter_feature(pa), "h_t": load_utter_feature(pt),
                "y": np.int64(self.label2id[str(row[self.label_col])]),
                "uid": str(row[self.uid_col])}
