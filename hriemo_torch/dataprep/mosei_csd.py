"""Minimal CMU-MultimodalSDK ``.csd`` reader (port of
``hriemo/dataprep/mosei_csd.py``; h5py, no mmsdk).

A computational-sequence file is HDF5 with layout::

    <root_key>/data/<video_id>/features   [N, d]
    <root_key>/data/<video_id>/intervals  [N, 2]  (start, end) seconds

plus a ``metadata`` group. ``h5py`` is imported inside the functions: the
rest of the port runs without it.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


class CsdFile:
    def __init__(self, path: str | Path):
        import h5py

        self._f = h5py.File(str(path), "r")
        roots = [k for k in self._f.keys() if k != "metadata"]
        if not roots:
            raise ValueError(f"No data root in {path}")
        self.root = roots[0]
        self._data = self._f[self.root]["data"]

    def keys(self) -> list[str]:
        return list(self._data.keys())

    def features(self, vid: str) -> np.ndarray:
        return np.asarray(self._data[vid]["features"])

    def intervals(self, vid: str) -> np.ndarray:
        return np.asarray(self._data[vid]["intervals"])

    def close(self):
        self._f.close()


def write_csd(path: str | Path, root_key: str, data: dict):
    """Create a ``.csd``-layout HDF5 file; ``data`` maps video_id ->
    ``(features [N, d], intervals [N, 2])``."""
    import h5py

    with h5py.File(str(path), "w") as f:
        grp = f.create_group(f"{root_key}/data")
        for vid, (feats, intervals) in data.items():
            g = grp.create_group(vid)
            g.create_dataset("features", data=np.asarray(feats))
            g.create_dataset("intervals", data=np.asarray(intervals, dtype=np.float64))
        f.create_group("metadata")


def slice_by_interval(feats: np.ndarray, intervals: np.ndarray,
                      start: float, end: float) -> np.ndarray:
    """The frames whose center lies in ``[start, end]``, else any that
    overlap it (the reference's per-segment slicing,
    extract_audio_feats_from_csd.py:102-127), fp32 with NaN/Inf set to 0."""
    centers = intervals.mean(axis=1)
    sel = (centers >= start) & (centers <= end)
    if not sel.any():
        sel = (intervals[:, 1] > start) & (intervals[:, 0] < end)
    out = feats[sel]
    return np.nan_to_num(out.astype(np.float32), nan=0.0, posinf=0.0, neginf=0.0)
