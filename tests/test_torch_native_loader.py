"""PyTorch port: the C++ feature loader (hriemo_torch/native.py over
hriemo_torch/csrc/feature_loader.cpp) against the JAX package's
(hriemo/native) on tests/test_native_loader.py's corpora, and against the
port's Python loader (CPU)."""

import shutil

import numpy as np
import pytest

from hriemo_torch.data.feature_store import load_feature, save_feature


@pytest.fixture(scope="module")
def loaders(tmp_path_factory):
    """Both libraries, built here on first use: the JAX package's into a
    directory of this test (its default, ``native/build/``, is shared by
    every test worker), the port's into ``hriemo_torch/_build/``."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: neither loader can be built")
    import hriemo.native as JN
    import hriemo_torch.native as TN

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JN, "_SO", tmp_path_factory.mktemp("jax_native") / "libhriemo_loader.so")
        mp.setattr(JN, "_tried", False)
        mp.setattr(JN, "_lib", None)
        assert JN.is_available() and TN.is_available()
        yield JN, TN


def _write_corpus(root, n=6, dmax=16):
    """tests/test_native_loader.py::_write_corpus: items of 3-11 frames, the
    first with a NaN row, each with its last frame padded in the file."""
    rng = np.random.default_rng(0)
    paths = []
    for i in range(n):
        length = int(rng.integers(3, 12))
        h = rng.standard_normal((length, dmax)).astype(np.float32)
        if i == 0:
            h[1, :] = np.nan
        m = np.ones(length, np.int64)
        m[length - 1] = 0
        save_feature(root / f"u{i}.npz", h, m)
        paths.append(str(root / f"u{i}.npz"))
    return paths


def _python_loader(paths, bucket, dim, max_len):
    """The same batch from the port's Python loader (load_feature, the
    dataset's center crop and mask reset, pad_batch's padding)."""
    from hriemo_torch.data.datasets import crop_center

    hid = np.zeros((len(paths), bucket, dim), np.float32)
    pad = np.ones((len(paths), bucket), bool)
    for i, p in enumerate(paths):
        h, m = load_feature(p)
        h = h.reshape(-1, dim)
        mask = m == 0
        if max_len > 0:
            h = crop_center(h, max_len)
            mask = np.zeros(h.shape[0], bool)
        n = min(h.shape[0], bucket)
        hid[i, :n], pad[i, :n] = h[:n], mask[:n]
    return hid, pad


def _case(name, root):
    """``(paths, bucket_len, dim, max_len, n_threads)`` of one corpus."""
    if name == "nan_and_file_mask":
        return _write_corpus(root), 10, 16, 0, 0
    if name == "crop":
        h = np.random.default_rng(1).standard_normal((20, 8)).astype(np.float32)
        save_feature(root / "x.npz", h, np.ones(20, np.int64))
        return [str(root / "x.npz")], 6, 8, 6, 0
    if name == "f64_vector":
        np.save(root / "v.npy", np.arange(8, dtype=np.float64))
        return [str(root / "v.npy")], 1, 8, 0, 0
    if name == "threaded":
        return _write_corpus(root, n=64) * 4, 12, 16, 0, 8
    raise ValueError(name)


@pytest.mark.parametrize("name", ["nan_and_file_mask", "crop", "f64_vector", "threaded"])
def test_native_matches_jax_and_python(loaders, tmp_path, name):
    """Hidden states and pad masks array-equal to ``hriemo.native``'s and to
    the port's Python loader's: NaN rows cleaned to 0, the file's mask kept,
    the center crop with its mask reset, f64 and ``[d]`` vector files."""
    JN, TN = loaders
    paths, bucket, dim, max_len, threads = _case(name, tmp_path)
    got = TN.assemble_modality(paths, bucket, dim, max_len=max_len, n_threads=threads)
    ref = JN.assemble_modality(paths, bucket, dim, max_len=max_len, n_threads=threads)
    py = _python_loader(paths, bucket, dim, max_len)
    for g, r, p in zip(got, ref, py):
        assert g.dtype == r.dtype == p.dtype and g.shape == r.shape == p.shape
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(g, p)
    if name == "nan_and_file_mask":
        assert (got[0][0, 1] == 0).all() and got[1][0].sum() > 0


@pytest.mark.parametrize("name", ["missing_file", "wrong_dim"])
def test_native_raises_as_jax(loaders, tmp_path, name):
    """A missing file and a file of another width raise ``IOError`` in both."""
    JN, TN = loaders
    path = tmp_path / "nope.npz"
    if name == "wrong_dim":
        save_feature(tmp_path / "a.npz", np.zeros((3, 5), np.float32), np.ones(3, np.int64))
        path = tmp_path / "a.npz"
    for mod in (TN, JN):
        with pytest.raises(IOError):
            mod.assemble_modality([str(path)], 4, 8)


def test_build_is_lazy_and_atomic(loaders):
    """Importing the binding builds nothing; the library is keyed by its
    source and flags and was renamed into place, no temporary left."""
    _, TN = loaders
    so = TN.library_path()
    assert so.exists() and so.parent.name == "_build"
    assert not list(so.parent.glob(f"{so.stem}.*.tmp.so"))
