"""PyTorch port: the training data layer, metrics and checkpoints
(hriemo_torch/data, hriemo_torch/utils) against the JAX package's (CPU)."""

import numpy as np
import pandas as pd
import pytest
import torch

from hriemo.data import BucketBatcher as JBatcher
from hriemo.data import SeqLevelDataset as JDataset
from hriemo.data import synthetic as JSyn
from hriemo.models import FusionWithEmotionDecoder, MoseiFusionWithEmotionDecoder
from hriemo.utils import checkpoint as JC
from hriemo.utils import metrics as JM
import hriemo_torch.models as TM
from hriemo_torch.data import BucketBatcher as TBatcher
from hriemo_torch.data import SeqLevelDataset as TDataset
from hriemo_torch.data import batching as TB
from hriemo_torch.data import read_index_csv
from hriemo_torch.data import synthetic as TSyn
from hriemo_torch.utils import checkpoint as TC
from hriemo_torch.utils import metrics as TMet

from torch_port_helpers import one_torch_thread  # noqa: F401


def _corpus(tmp_path, kind):
    if kind == "mosei":
        return (JSyn.make_synthetic_mosei(tmp_path / "jax", n=30, seed=4),
                TSyn.make_synthetic_mosei(tmp_path / "port", n=30, seed=4))
    return (JSyn.make_synthetic_iemocap(tmp_path / "jax", n=30, d=8, seq_level=True, seed=4),
            TSyn.make_synthetic_iemocap(tmp_path / "port", n=30, d=8, seq_level=True, seed=4))


@pytest.mark.parametrize("kind", ["mosei", "iemocap"])
def test_synthetic_corpora_match_jax(tmp_path, kind):
    (jcsv, jaud, jtxt), (tcsv, taud, ttxt) = _corpus(tmp_path, kind)
    assert tcsv.read_text() == jcsv.read_text()
    for jd, td in ((jaud, taud), (jtxt, ttxt)):
        assert (td / "meta.json").read_text() == (jd / "meta.json").read_text()
        names = sorted(p.name for p in jd.glob("*.npz"))
        assert names == sorted(p.name for p in td.glob("*.npz")) and names
        for name in names:
            with np.load(jd / name) as a, np.load(td / name) as b:
                assert sorted(a.files) == sorted(b.files)
                for k in a.files:
                    np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("accum", [1, 2])
def test_bucket_batcher_matches_jax(tmp_path, accum):
    """Same corpus and seed: the same batches, uids, n_valid and
    ``[accum, micro, ...]`` layout, over two shuffled epochs and the padded
    eval tail. The crop caps are below some lengths (center crop, mask
    reset) and above others (padding)."""
    (jcsv, jaud, jtxt), _ = _corpus(tmp_path, "mosei")
    emo = JSyn.MOSEI_EMO_COLS
    df = pd.read_csv(jcsv)
    rows, cols = read_index_csv(jcsv)
    kw = dict(uid_col="uid", emo_cols=emo, max_len_audio=30, max_len_text=12)
    jds, tds = JDataset(df, jaud, jtxt, **kw), TDataset(rows, jaud, jtxt, columns=cols, **kw)
    for shuffle, drop_last in ((True, True), (False, False)):
        bkw = dict(batch_size=4, la=36, lt=12, shuffle=shuffle, seed=9, drop_last=drop_last,
                   grad_accum=accum if drop_last else 1)
        jb, tb = JBatcher(jds, **bkw), TBatcher(tds, **bkw)
        assert len(jb) == len(tb)
        for _ in range(2):
            got, ref = list(tb), list(jb)
            assert len(got) == len(ref) > 0
            for g, r in zip(got, ref):
                assert sorted(g) == sorted(r)
                assert g["n_valid"] == r["n_valid"] and g["uids"] == r["uids"]
                for k in ("h_a", "h_t", "mask_a", "mask_t", "y"):
                    assert g[k].dtype == r[k].dtype and g[k].shape == r[k].shape, k
                    np.testing.assert_array_equal(g[k], r[k], err_msg=k)


def test_seq_dataset_labels_and_filtering_match_jax(tmp_path):
    (jcsv, jaud, jtxt), _ = _corpus(tmp_path, "iemocap")
    df = pd.read_csv(jcsv)
    (jaud / f"{df.utter_id[3]}.npz").unlink()  # one row loses its audio
    rows, cols = read_index_csv(jcsv)
    label2id = {lab: i for i, lab in enumerate(sorted(set(df.label)))}
    kw = dict(label_col="label", label2id=label2id, max_len_audio=25, max_len_text=0)
    jds, tds = JDataset(df, jaud, jtxt, **kw), TDataset(rows, jaud, jtxt, **kw)
    assert len(tds) == len(jds) == 29 and tds.uid_col == jds.uid_col == "utter_id"
    for i in range(len(jds)):
        g, r = tds[i], jds[i]
        assert g["uid"] == r["uid"] and g["y"] == r["y"] and g["y"].dtype == r["y"].dtype
        for k in ("h_a", "h_t", "mask_a", "mask_t"):
            np.testing.assert_array_equal(g[k], r[k])


@pytest.mark.parametrize("n,drop_last", [(24, False), (22, True), (22, False)])
def test_host_shards_match_jax(tmp_path, n, drop_last):
    """``host_shard=(i, 3)``: uid for uid the JAX batcher's shards (the port
    of tests/test_data.py:146-186) over two shuffled epochs, every host the
    same batch count; on an even corpus the shards are disjoint and cover
    it, on an uneven one ``drop_last`` truncates and otherwise the order
    wraps."""
    jcsv, jaud, jtxt = JSyn.make_synthetic_mosei(tmp_path, n=n, max_la=10, max_lt=6, seed=4)
    rows, cols = read_index_csv(jcsv)
    kw = dict(uid_col="uid", emo_cols=JSyn.MOSEI_EMO_COLS)
    jds = JDataset(pd.read_csv(jcsv), jaud, jtxt, verbose=False, **kw)
    tds = TDataset(rows, jaud, jtxt, columns=cols, verbose=False, **kw)
    bkw = dict(batch_size=4, la=12, lt=8, shuffle=True, seed=7, drop_last=drop_last)
    shards, counts = [], set()
    for host in range(3):
        jb = JBatcher(jds, host_shard=(host, 3), **bkw)
        tb = TBatcher(tds, host_shard=(host, 3), **bkw)
        assert len(tb) == len(jb)
        for _ in range(2):
            got, ref = list(tb), list(jb)
            assert len(got) == len(ref) == len(tb)
            assert [b["uids"] for b in got] == [b["uids"] for b in ref]
            assert [b["n_valid"] for b in got] == [b["n_valid"] for b in ref]
            np.testing.assert_array_equal(np.concatenate([b["h_a"] for b in got]),
                                          np.concatenate([b["h_a"] for b in ref]))
        shards.append([u for b in got for u in b["uids"]])
        counts.add(len(got))
    flat = [u for uids in shards for u in uids]
    assert len(counts) == 1
    if n % 3 == 0:
        assert len(flat) == len(set(flat)) == n


def test_native_host_shards_match_python_loader(tmp_path):
    """The C++ loader honours ``host_shard``: its shards equal the Python
    loader's bit for bit."""
    tcsv, taud, ttxt = TSyn.make_synthetic_mosei(tmp_path, n=22, max_la=20, max_lt=10, seed=4)
    rows, cols = read_index_csv(tcsv)
    ds = TDataset(rows, taud, ttxt, emo_cols=[c for c in cols if c.startswith("emo_")],
                  max_len_audio=12, verbose=False)
    for host in range(2):
        kw = dict(shuffle=True, seed=3, drop_last=False, host_shard=(host, 2))
        py, nat = (TBatcher(ds, 4, la=16, lt=12, native=n, **kw) for n in (False, True))
        assert nat.native and not py.native
        got, ref = list(nat), list(py)
        assert len(got) == len(ref) == len(py) > 0
        for bn, bp in zip(got, ref):
            assert bn["uids"] == bp["uids"] and bn["n_valid"] == bp["n_valid"]
            for k in ("h_a", "h_t", "mask_a", "mask_t", "y"):
                np.testing.assert_array_equal(bn[k], bp[k], err_msg=k)


@pytest.mark.parametrize("bad", [(-1, 3), (3, 3), (0, 0)])
def test_malformed_host_shard_is_refused(tmp_path, bad):
    tcsv, taud, ttxt = TSyn.make_synthetic_mosei(tmp_path, n=4, seed=4)
    rows, cols = read_index_csv(tcsv)
    ds = TDataset(rows, taud, ttxt, columns=cols, verbose=False)
    for batcher in (TBatcher, JBatcher):  # the port refuses what JAX refuses
        with pytest.raises(ValueError, match="host_shard"):
            batcher(ds, 4, la=12, lt=8, host_shard=bad)


def test_prefetch_to_device_keeps_batches_and_order():
    batches = [{"h_a": np.full((2, 3), i, np.float32), "n_valid": 2, "uids": [f"u{i}"]}
               for i in range(3)]
    out = list(TB.prefetch_to_device(iter(batches), "cpu"))
    assert [b["uids"] for b in out] == [["u0"], ["u1"], ["u2"]]
    for i, b in enumerate(out):
        assert isinstance(b["h_a"], torch.Tensor) and float(b["h_a"][0, 0]) == i
        assert b["n_valid"] == 2


@pytest.mark.parametrize("layout", ["train", "eval"])
def test_native_batcher_matches_python_batcher(tmp_path, layout):
    """``BucketBatcher(native=True)`` assembles with the C++ loader, and its
    batches equal the Python loader's bit for bit (keys, dtypes, uids,
    ``n_valid``), under the audio cap's crop and mask reset, the shuffle and
    the ``grad_accum`` layout, or the eval tail; a ``.pt`` corpus and
    utter-level items fall back to the Python loader."""
    tcsv, taud, ttxt = TSyn.make_synthetic_mosei(tmp_path, n=30, max_la=20, max_lt=10, seed=4)
    rows, cols = read_index_csv(tcsv)
    emo = [c for c in cols if c.startswith("emo_")]
    ds = TDataset(rows, taud, ttxt, emo_cols=emo, max_len_audio=12, max_len_text=0,
                  verbose=False)
    kw = (dict(shuffle=True, seed=3, grad_accum=2, drop_last=True) if layout == "train"
          else dict(drop_last=False))
    py, nat = (TBatcher(ds, 4, la=16, lt=12, native=n, **kw) for n in (False, True))
    assert nat.native and not py.native
    got, ref = list(nat), list(py)
    assert len(got) == len(ref) == len(py) > 0
    for bn, bp in zip(got, ref):
        assert bn.keys() == bp.keys() and bn["uids"] == bp["uids"]
        assert bn["n_valid"] == bp["n_valid"]
        for k in ("h_a", "h_t", "mask_a", "mask_t", "y"):
            assert bn[k].dtype == bp[k].dtype and bn[k].shape == bp[k].shape, k
            np.testing.assert_array_equal(bn[k], bp[k], err_msg=k)
    pcsv, paud, ptxt = TSyn.make_synthetic_mosei(tmp_path / "pt", n=8, seed=4, fmt="pt")
    prow, pcols = read_index_csv(pcsv)
    assert not TBatcher(TDataset(prow, paud, ptxt, emo_cols=emo, verbose=False), 4, la=16,
                        lt=12, native=True).native
    assert not TBatcher(ds, 4, utter_level=True, native=True).native


def test_metrics_equal_jax():
    rng = np.random.default_rng(5)
    y_raw = rng.uniform(-1, 3, (40, 6))
    y_raw[:, 5] = -1.0                 # a degenerate column: AUC skips it
    probs = rng.uniform(0, 1, (40, 6))
    probs[:4, 0] = probs[4:8, 0] = 0.25  # ties
    yb = JM.binarize_truth(y_raw)
    np.testing.assert_array_equal(TMet.binarize_truth(y_raw), yb)
    pred = (probs >= 0.5).astype(int)
    for fn in ("micro_f1", "macro_f1"):
        assert getattr(TMet, fn)(yb, pred) == getattr(JM, fn)(yb, pred)
    assert TMet.macro_auc(yb, probs) == JM.macro_auc(yb, probs)
    assert TMet.average_precision(yb[:, 0], probs[:, 0]) == \
        JM.average_precision(yb[:, 0], probs[:, 0])
    for got, ref in zip(TMet.calibrate_thresholds(yb, probs), JM.calibrate_thresholds(yb, probs)):
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(TMet.pos_weights(yb), JM.pos_weights(yb))
    assert TMet.summary_metrics(y_raw, probs) == JM.summary_metrics(y_raw, probs)


TINY = dict(d_model=32, n_heads=4, num_layers_fusion=1, num_layers_decoder=1, beta_hidden=16)


@pytest.mark.parametrize("kind", ["iemocap", "mosei"])
def test_checkpoints_load_strictly_across(tmp_path, kind):
    """Each side's best_*.pt (the reference layout) loads strictly into the
    other side's model, with the same tensors."""
    if kind == "mosei":
        kw = dict(d_audio=10, d_text=12, num_emotions=6, **TINY)
        jm, tm = MoseiFusionWithEmotionDecoder(**kw), TM.MoseiFusionWithEmotionDecoder(**kw)
    else:
        kw = dict(num_emotions=4, **TINY)
        jm, tm = FusionWithEmotionDecoder(**kw), TM.FusionWithEmotionDecoder(**kw)
    tm.init_weights(torch.Generator().manual_seed(3))
    meta = {"args": {"d_model": 32}, "epoch": 2}

    port_path = str(tmp_path / "port.pt")
    TC.save_torch_checkpoint(port_path, {"model_state_dict": TC.state_dict_cpu(tm), **meta})
    ckpt = JC.load_model_from_torch_checkpoint(jm, port_path)
    assert ckpt["epoch"] == 2
    ref = JC.state_dict_from_params(jm.params)
    for name, t in tm.state_dict().items():
        np.testing.assert_array_equal(ref[name], t.numpy())

    jax_path = str(tmp_path / "jax.pt")
    JC.save_torch_checkpoint(jax_path, {"model_state_dict":
                                        JC.state_dict_from_params(jm.params), **meta})
    fresh = type(tm)(**kw)
    assert TC.load_model_from_torch_checkpoint(fresh, jax_path)["args"] == {"d_model": 32}
    for (name, a), b in zip(tm.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), name
