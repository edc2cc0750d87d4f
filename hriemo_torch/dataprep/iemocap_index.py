#!/usr/bin/env python3
"""IEMOCAP corpus index and session splits (port of
``hriemo/dataprep/iemocap_index.py``, without pandas).

Behavioral contract, the JAX builder's:
  * EmoEvaluation headers ``[start - end] utter_id LAB [v, a, d]`` parsed
    by regex;
  * keep 6 classes {ang, hap, sad, neu, fru, exc} mapped to long names;
  * audio from ``sentences/**/*.wav``; text preferred from dialog
    transcripts (line keyed by utter id, tags/noise markers cleaned),
    ``.wdseg`` forced-alignment word list as fallback;
  * split rule: Session5 -> test, Session4 -> val, rest -> train;
  * emits ``iemocap_index.csv`` and ``iemocap_index_splits.csv`` with the
    same columns, rows and CSV quoting as the JAX builder.

    python -m hriemo_torch.dataprep.iemocap_index --base IEMOCAP_full_release --out_dir data
"""

from __future__ import annotations

import argparse
import collections
import csv
import re
from pathlib import Path

HEAD_RE = re.compile(
    r"^\[(\d+\.\d+)\s*-\s*(\d+\.\d+)\]\s+(\S+)\s+([A-Za-z]{3})\s*\[\s*([\d\.\s,]+)\s*\]\s*$"
)
KEEP_6 = {"ang": "angry", "hap": "happy", "sad": "sad",
          "neu": "neutral", "fru": "frustration", "exc": "excited"}
UID_RE = re.compile(r"(Ses\d{2}[MF]_[A-Za-z]+\d+_[MF]\d{3,4})")
DIALOG_RE = re.compile(r"^(Ses\d{2}[MF]_[A-Za-z]+\d+)_")
NOISE_WORDS = {"sil", "sp", "garbage", "<sil>", "</s>", "<s>"}
INDEX_COLUMNS = ["utter_id", "session", "audio_path", "text", "label"]
# the JAX builder's merged frame: index columns, then label, text, split
SPLIT_COLUMNS = ["session", "utter_id", "audio_path", "wdseg_path", "transcript_path",
                 "label", "text", "split"]


def read_text_robust(path: Path) -> str:
    for enc in ("utf-8", "utf-8-sig", "cp1252", "latin-1"):
        try:
            return path.read_text(encoding=enc)
        except UnicodeDecodeError:
            continue
    return path.read_text(encoding="utf-8", errors="ignore")


def uid_from_stem(stem: str) -> str | None:
    m = UID_RE.search(stem)
    return m.group(1) if m else None


def dialog_id(uid: str) -> str | None:
    m = DIALOG_RE.match(uid)
    return m.group(1) if m else None


def clean_transcript_line(line: str) -> str:
    """Strip the uid/timestamp prefix and noise/markup tags."""
    line = re.sub(r"^Ses\d{2}[MF]_[A-Za-z]+\d+_[MF]\d{3,4}\s*\[.*?\]\s*:\s*", "", line)
    line = re.sub(r"</?s>", " ", line, flags=re.I)
    line = re.sub(r"<\s*(sil|sp|noise|laughter)\s*>", " ", line, flags=re.I)
    line = re.sub(r"\(\d+\)", " ", line)
    line = re.sub(r"<[^>]+>", " ", line)
    return re.sub(r"\s+", " ", line).strip()


def text_from_transcript(path: Path, uid: str) -> str | None:
    pat = re.compile(rf"^{re.escape(uid)}\b")
    try:
        for raw in read_text_robust(path).splitlines():
            if pat.search(raw):
                return clean_transcript_line(raw)
    except FileNotFoundError:
        return None
    return None


def wdseg_to_text(path: Path) -> str:
    """Forced-alignment word list -> plain text (fallback)."""
    words = []
    try:
        for line in read_text_robust(path).splitlines():
            parts = line.strip().split()
            if len(parts) >= 3:
                # skip header/footer lines ("SFrm EFrm SegAScr Word", totals)
                if not parts[0].lstrip("-").isdigit():
                    continue
                w = parts[-1].lower()
                if w in NOISE_WORDS:
                    continue
                w = re.sub(r"[{}<>]", "", w)
                # strip sphinx alternate-pronunciation suffixes like word(2)
                w = re.sub(r"\(\d+\)$", "", w)
                if w:
                    words.append(w)
    except FileNotFoundError:
        return ""
    return " ".join(words)


def parse_emotion_labels(base: Path) -> list[dict]:
    rows = []
    for sess_dir in sorted(base.glob("Session*")):
        emo_dir = sess_dir / "dialog" / "EmoEvaluation"
        if not emo_dir.is_dir():
            continue
        for emo_file in sorted(emo_dir.glob("*.txt")):
            for line in read_text_robust(emo_file).splitlines():
                m = HEAD_RE.match(line.strip())
                if not m:
                    continue
                start, end, uid, lab, vad = m.groups()
                lab = lab.lower()
                if lab in KEEP_6:
                    rows.append({
                        "session": sess_dir.name, "utter_id": uid,
                        "label": KEEP_6[lab],
                        "t_start": float(start), "t_end": float(end), "vad": vad,
                    })
    return rows


def _pick_text(row) -> str | None:
    # transcript preferred; forced-alignment fallback
    if row["transcript_path"] is not None:
        txt = text_from_transcript(row["transcript_path"], row["utter_id"])
        if txt:
            return txt
    if row["wdseg_path"] is not None:
        return wdseg_to_text(row["wdseg_path"]) or None
    return None


def build_index(base: Path) -> list[dict]:
    """Rows (dicts) of the labelled utterances that have audio and text,
    sorted by (session, utter_id): the JAX builder's inner merge of the
    file index with the labels, row for row."""
    labels = collections.defaultdict(list)
    for lab in parse_emotion_labels(base):
        labels[(lab["session"], lab["utter_id"])].append(lab["label"])
    if not labels:
        raise SystemExit(f"No EmoEvaluation labels found under {base}")

    rows = []
    for sess_dir in sorted(base.glob("Session*")):
        wav_map = {uid_from_stem(p.stem): p
                   for p in (sess_dir / "sentences").rglob("*.wav")
                   if uid_from_stem(p.stem)}
        wdseg_map = {uid_from_stem(p.stem): p
                     for p in (sess_dir / "sentences" / "ForcedAlignment").rglob("*.wdseg")
                     if uid_from_stem(p.stem)}
        txt_map = {p.stem: p
                   for p in (sess_dir / "dialog" / "transcriptions").rglob("*.txt")}
        for uid in sorted(set(wav_map) | set(wdseg_map)):
            did = dialog_id(uid)
            for label in labels.get((sess_dir.name, uid), []):
                rows.append({
                    "session": sess_dir.name, "utter_id": uid,
                    "audio_path": wav_map.get(uid),
                    "wdseg_path": wdseg_map.get(uid),
                    "transcript_path": txt_map.get(did) if did else None,
                    "label": label,
                })
    final = []
    for row in rows:
        row["text"] = _pick_text(row)
        if row["audio_path"] is not None and row["text"] is not None:
            final.append(row)
    final.sort(key=lambda r: (r["session"], r["utter_id"]))
    for row in final:
        for col in ("audio_path", "wdseg_path", "transcript_path"):
            if row[col] is not None:
                row[col] = str(Path(row[col]).resolve())
    return final


def assign_splits(rows: list[dict]) -> list[dict]:
    split_map = {"Session5": "test", "Session4": "val"}
    return [dict(r, split=split_map.get(r["session"], "train")) for r in rows]


def write_csv(path: Path, rows: list[dict], columns: list[str]) -> None:
    """pandas ``to_csv(index=False)``'s format: minimal quoting, ``\\n``
    line ends, None as an empty field."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(columns)
        for r in rows:
            w.writerow([r[c] for c in columns])


def read_csv(path) -> list[dict]:
    """Rows of an index CSV as dicts of strings."""
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", type=str, required=True,
                    help="IEMOCAP_full_release directory")
    ap.add_argument("--out_dir", type=str, default="data")
    args = ap.parse_args(argv)

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rows = build_index(Path(args.base))
    write_csv(out_dir / "iemocap_index.csv", rows, INDEX_COLUMNS)
    rows = assign_splits(rows)
    write_csv(out_dir / "iemocap_index_splits.csv", rows, SPLIT_COLUMNS)
    print(f"[index] {len(rows)} aligned samples")
    for split, n in sorted(collections.Counter(r["split"] for r in rows).items()):
        print(f"  {split}: {n}")
    for (split, label), n in sorted(collections.Counter(
            (r["split"], r["label"]) for r in rows).items()):
        print(f"  {split} {label}: {n}")
    return out_dir / "iemocap_index_splits.csv"


if __name__ == "__main__":
    main()
