"""Host-side audio preprocessing (scipy-based; no torchaudio dependency; a
copy of ``hriemo/dataprep/audio.py``, which the port does not import).

Reproduces the reference's WavLM input pipeline
(reference: extract_audio_feats_wavlm_seq.py:67-87):
mono mix → resample to 16 kHz → peak normalise → pad/truncate to 10 s.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

TARGET_SR = 16_000
MAX_SECONDS = 10.0


def load_wav(path: str | Path) -> tuple[np.ndarray, int]:
    """PCM wav → (float32 [T] or [T, C], sample_rate)."""
    from scipy.io import wavfile

    sr, data = wavfile.read(str(path))
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    return data, int(sr)


def to_mono(wav: np.ndarray) -> np.ndarray:
    return wav.mean(axis=1) if wav.ndim == 2 else wav


def resample(wav: np.ndarray, sr: int, target_sr: int = TARGET_SR) -> np.ndarray:
    if sr == target_sr:
        return wav
    from scipy.signal import resample_poly

    g = math.gcd(sr, target_sr)
    return resample_poly(wav, target_sr // g, sr // g).astype(np.float32)


def peak_normalize(wav: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    peak = np.abs(wav).max()
    return wav / max(peak, eps)


def pad_or_truncate(wav: np.ndarray, max_seconds: float = MAX_SECONDS,
                    sr: int = TARGET_SR, pad: bool = True) -> tuple[np.ndarray, int]:
    """Returns (waveform [T_max or ≤T_max], n_valid_samples).

    seq-level extraction pads to exactly 10 s (reference :81-87);
    utter-level only truncates (reference extract_audio_feats_wavlm.py:52-54).
    """
    limit = int(max_seconds * sr)
    n = min(len(wav), limit)
    wav = wav[:n]
    if pad and n < limit:
        wav = np.pad(wav, (0, limit - n))
    return wav.astype(np.float32), n


def prepare_waveform(path: str | Path, pad: bool = True,
                     max_seconds: float = MAX_SECONDS) -> tuple[np.ndarray, int]:
    """Full preprocessing chain → (waveform, n_valid_samples)."""
    wav, sr = load_wav(path)
    wav = peak_normalize(resample(to_mono(wav), sr))
    return pad_or_truncate(wav, max_seconds=max_seconds, pad=pad)
