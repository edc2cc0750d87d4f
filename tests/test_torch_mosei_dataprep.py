"""PyTorch port: the MOSEI data prep (hriemo_torch/dataprep/{mosei_csd,
standard_folds,mosei_index,extract_mosei}.py) against the JAX CLIs on
``.csd`` files written with h5py, as tests/test_dataprep.py writes them
(CPU)."""

import json

import numpy as np
import pytest

pytest.importorskip("h5py")

from hriemo.dataprep import extract_mosei as JEX  # noqa: E402
from hriemo.dataprep import mosei_csd as JCSD  # noqa: E402
from hriemo.dataprep import mosei_index as JIDX  # noqa: E402
from hriemo.dataprep import standard_folds as JSF  # noqa: E402
from hriemo_torch.data.feature_store import load_feature, read_meta  # noqa: E402
from hriemo_torch.dataprep import extract_mosei as TEX  # noqa: E402
from hriemo_torch.dataprep import mosei_csd as TCSD  # noqa: E402
from hriemo_torch.dataprep import mosei_index as TIDX  # noqa: E402
from hriemo_torch.dataprep import standard_folds as TSF  # noqa: E402

FOLDS = {"train": ["video0", "video1"], "valid": ["video2"], "test": ["video3"]}


@pytest.fixture(scope="module")
def csds(tmp_path_factory):
    """tests/test_dataprep.py's corpus (4 videos of 3 segments, COVAREP at
    10 Hz with NaN rows, word vectors at 1 Hz), plus a fifth video outside
    the folds and a NaN sentiment and emotion."""
    root = tmp_path_factory.mktemp("mosei")
    rng = np.random.default_rng(1)
    labels, covarep, words = {}, {}, {}
    for v in range(5):
        vid = f"video{v}"
        seg_iv = np.asarray([[i * 5.0, i * 5.0 + 4.0] for i in range(3)])
        lab = rng.uniform(-1, 3, size=(3, 7))
        if v == 1:
            lab[2, 0] = lab[1, 3] = np.nan
        labels[vid] = (lab, seg_iv)
        iv = np.stack([np.arange(150) * 0.1, np.arange(150) * 0.1 + 0.1], 1)
        feats = rng.standard_normal((150, 74))
        feats[::17] = np.nan
        covarep[vid] = (feats, iv)
        wiv = np.stack([np.arange(15) * 1.0, np.arange(15) + 1.0], 1)
        words[vid] = (rng.standard_normal((15, 300)), wiv)
    JCSD.write_csd(root / "labels.csd", "CMU_MOSEI_Labels", labels)
    TCSD.write_csd(root / "covarep.csd", "CMU_MOSEI_COVAREP", covarep)
    TCSD.write_csd(root / "words.csd", "CMU_MOSEI_WordVectors", words)
    (root / "folds.json").write_text(json.dumps(FOLDS))
    sdk = root / "sdk" / "mmsdk" / "CMU_MOSEI"
    sdk.mkdir(parents=True)
    (sdk / "cmu_mosei_std_folds.py").write_text(
        "standard_train_fold=['video0','video3']\nstandard_valid_fold=['video1']\n"
        "standard_test_fold=['video2']\n")
    return root


def test_csd_reader_and_slicing_match_jax(csds):
    """The same keys, features and intervals, and the same frames for a
    center-inside interval, an overlap-only interval and one with none."""
    j, t = JCSD.CsdFile(csds / "covarep.csd"), TCSD.CsdFile(csds / "covarep.csd")
    assert t.keys() == j.keys() and t.root == j.root
    for vid in t.keys():
        np.testing.assert_array_equal(t.features(vid), j.features(vid))
        np.testing.assert_array_equal(t.intervals(vid), j.intervals(vid))
    feats, iv = t.features("video0"), t.intervals("video0")
    for start, end in ((2.0, 5.0), (3.62, 3.64), (100.0, 101.0)):
        got = TCSD.slice_by_interval(feats, iv, start, end)
        ref = JCSD.slice_by_interval(feats, iv, start, end)
        assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
    j.close()
    t.close()


@pytest.mark.parametrize("source", ["folds_json", "sdk_path", "hash_split"])
def test_mosei_index_csv_byte_equal(csds, tmp_path, source):
    """``mosei_index_splits.csv`` byte-equal to the JAX CLI's (pandas), for
    each folds source; videos outside the folds dropped, NaN sentiment an
    empty field."""
    flags = {"folds_json": ["--folds_json", str(csds / "folds.json")],
             "sdk_path": ["--sdk_path", str(csds / "sdk")],
             "hash_split": ["--allow_nonstandard_split"]}[source]
    argv = ["--labels_csd", str(csds / "labels.csd")] + flags
    ref = JIDX.main(argv + ["--out_dir", str(tmp_path / "jax")])
    got = TIDX.main(argv + ["--out_dir", str(tmp_path / "port")])
    assert got.name == ref.name
    text = got.read_text()
    assert text == ref.read_text()
    n = len(text.splitlines()) - 1
    assert n == (15 if source == "hash_split" else 12)
    assert ",," in text  # the NaN sentiment


def test_mosei_index_refuses_without_folds(csds, tmp_path):
    """No folds source and no opt-in: both CLIs exit naming the standard folds."""
    argv = ["--labels_csd", str(csds / "labels.csd"), "--out_dir", str(tmp_path)]
    for main in (JIDX.main, TIDX.main):
        with pytest.raises(SystemExit, match="standard folds"):
            main(argv)


@pytest.mark.parametrize("fmt", ["npz", "pt"])
def test_extract_mosei_array_equal(csds, tmp_path, fmt):
    """Audio and text features of every indexed segment array-equal to the
    JAX CLI's, in ``npz`` and ``pt``; ``meta.json`` equal."""
    idx = JIDX.main(["--labels_csd", str(csds / "labels.csd"), "--folds_json",
                     str(csds / "folds.json"), "--out_dir", str(tmp_path)])
    for modality, csd, min_frames in (("audio", "covarep.csd", "1"), ("text", "words.csd", "4")):
        argv = ["--modality", modality, "--feats_csd", str(csds / csd), "--index_csv",
                str(idx), "--fmt", fmt, "--min_frames", min_frames]
        jdir = JEX.main(argv + ["--out_dir", str(tmp_path / f"jax_{modality}")])
        tdir = TEX.main(argv + ["--out_dir", str(tmp_path / f"port_{modality}")])
        jfiles = sorted(p.name for p in jdir.glob(f"*.{fmt}"))
        assert sorted(p.name for p in tdir.glob(f"*.{fmt}")) == jfiles and len(jfiles) == 12
        for name in jfiles:
            (gh, gm), (rh, rm) = load_feature(tdir / name), load_feature(jdir / name)
            assert gh.dtype == rh.dtype and gm.dtype == rm.dtype
            np.testing.assert_array_equal(gh, rh)
            np.testing.assert_array_equal(gm, rm)
        assert read_meta(tdir) == read_meta(jdir)
    assert load_feature(tmp_path / f"port_audio/video0_1.{fmt}")[0].shape == (40, 74)


def test_extract_mosei_fails_as_jax_when_nothing_matches(csds, tmp_path):
    """An index whose videos are not in the ``.csd``: both exit."""
    idx = tmp_path / "idx.csv"
    idx.write_text("uid,video_id,t_start,t_end\nzz_0,zz,0.0,4.0\n")
    argv = ["--modality", "audio", "--feats_csd", str(csds / "covarep.csd"),
            "--index_csv", str(idx)]
    for main, d in ((JEX.main, "j"), (TEX.main, "t")):
        with pytest.raises(SystemExit, match="no segments extracted"):
            main(argv + ["--out_dir", str(tmp_path / d)])


def test_standard_folds_chain_matches_jax(csds, tmp_path, monkeypatch):
    """The same folds from each source of the chain (SDK checkout, the
    packaged file, an explicit JSON with the ``val`` alias, which wins over
    the packaged file) and the same errors (a source missing a list; no
    source at all)."""
    sdk = csds / "sdk"
    assert TSF.folds_from_sdk_checkout(sdk) == JSF.folds_from_sdk_checkout(sdk)
    packaged = tmp_path / "packaged.json"
    TSF.export_packaged_folds(TSF.folds_from_sdk_checkout(sdk), packaged)
    for mod in (TSF, JSF):
        monkeypatch.setattr(mod, "PACKAGED_FOLDS", packaged)
    assert TSF.load_standard_folds() == JSF.load_standard_folds() == \
        JSF.folds_from_sdk_checkout(sdk)
    other = tmp_path / "other.json"
    other.write_text(json.dumps({"train": ["x"], "val": ["y"], "test": ["z"]}))
    assert TSF.load_standard_folds(other) == JSF.load_standard_folds(other)
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"train": ["x"], "test": ["z"]}))
    for mod in (TSF, JSF):
        with pytest.raises(mod.FoldsUnavailable, match="missing the 'valid' list"):
            mod.load_standard_folds(bad)
        monkeypatch.setattr(mod, "PACKAGED_FOLDS", tmp_path / "missing.json")
        with pytest.raises(mod.FoldsUnavailable, match="standard folds not found"):
            mod.load_standard_folds()
        with pytest.raises(mod.FoldsUnavailable, match="no cmu_mosei_std_folds.py"):
            mod.load_standard_folds(sdk_path=tmp_path)
