"""ctypes binding of the port's C++ feature loader
(``hriemo_torch/csrc/feature_loader.cpp``; port of ``hriemo/native``).

The library is built with g++ on first use, never at import, into
``hriemo_torch/_build/`` under a name keyed by the source's hash. The
compiler writes a file of its own, which then takes the final name by
``os.replace``, so a process never loads a half-written library while
another builds it. Where g++ or the build is not available,
:func:`is_available` says False and callers take the Python loader.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "csrc" / "feature_loader.cpp"
_BUILD = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lib = None
_tried = False
_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + _SRC.read_bytes()).hexdigest()[:16]
    return _BUILD / f"libhriemo_torch_loader_{h}.so"


def _build(so: Path) -> bool:
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so)
        return True
    except Exception as e:  # no toolchain, or a compile error
        print(f"[native] build failed ({e}); using the Python loader")
        tmp.unlink(missing_ok=True)
        return False


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        so = library_path()
        if not so.exists() and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            print(f"[native] load failed ({e}); using the Python loader")
            return None
        lib.hriemo_assemble.restype = ctypes.c_int
        lib.hriemo_assemble.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int]
        _lib = lib
        return _lib


def is_available() -> bool:
    """Whether the library builds and loads here (builds it on first call)."""
    return _load() is not None


def assemble_modality(paths: list[str], bucket_len: int, dim: int, max_len: int = 0,
                      n_threads: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Threaded batch assembly of one modality: ``(hidden [n, bucket_len,
    dim] f32, pad_mask [n, bucket_len] bool)``, True = PAD, with the Python
    loader's semantics (NaN-clean; with ``max_len > 0`` a center crop and
    the mask reset to all-valid). Raises ``IOError`` when a file fails to
    load or has another width than ``dim``."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native loader unavailable")
    n = len(paths)
    hidden = np.empty((n, bucket_len, dim), np.float32)
    pad = np.empty((n, bucket_len), np.uint8)
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    if n_threads <= 0:
        n_threads = min(8, os.cpu_count() or 1)
    failures = lib.hriemo_assemble(
        c_paths, n, hidden.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        pad.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), bucket_len, dim, max_len,
        n_threads)
    if failures:
        raise IOError(f"native loader: {failures}/{n} feature files failed to load")
    return hidden, pad.astype(bool)
