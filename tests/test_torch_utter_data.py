"""PyTorch port: the utter-level data layer (UtterLevelDataset,
stack_utter_batch and BucketBatcher(utter_level=True); hriemo_torch/data)
against the JAX package's on one synthetic corpus and seed."""

import numpy as np
import pandas as pd
import pytest

from hriemo.data import BucketBatcher as JBatcher
from hriemo.data import UtterLevelDataset as JDataset
from hriemo.data import synthetic as JSyn
from hriemo.data.batching import stack_utter_batch as j_stack
from hriemo_torch.data import BucketBatcher as TBatcher
from hriemo_torch.data import UtterLevelDataset as TDataset
from hriemo_torch.data import read_index_csv, stack_utter_batch


def _corpus(tmp_path):
    """30 utter-level utterances; one row loses its text feature file."""
    csv_path, audio_dir, text_dir = JSyn.make_synthetic_iemocap(
        tmp_path, n=30, d=8, seq_level=False, seed=5)
    df = pd.read_csv(csv_path)
    gone = str(df[df["split"] == "train"].iloc[3]["utter_id"])
    next(text_dir.glob(f"{gone}.*")).unlink()
    return csv_path, audio_dir, text_dir, gone


def _same(jb, tb):
    assert set(jb) == set(tb)
    for k in jb:
        if k in ("uids", "n_valid"):
            assert jb[k] == tb[k], k
        else:
            assert jb[k].dtype == tb[k].dtype and jb[k].shape == tb[k].shape, k
            np.testing.assert_array_equal(jb[k], tb[k], err_msg=k)


def test_utter_dataset_drops_the_row_without_both_modalities(tmp_path, capsys):
    csv_path, audio_dir, text_dir, gone = _corpus(tmp_path)
    df = pd.read_csv(csv_path)
    rows, cols = read_index_csv(csv_path)
    train = df[df["split"] == "train"]
    jd = JDataset(train, audio_dir, text_dir)
    td = TDataset([r for r in rows if r["split"] == "train"], audio_dir, text_dir, columns=cols)
    assert "Filtered out 1 rows" in capsys.readouterr().out
    assert len(td) == len(jd) == len(train) - 1 and td.label2id == jd.label2id
    assert gone not in [td[i]["uid"] for i in range(len(td))]
    for i in range(len(td)):
        a, b = jd[i], td[i]
        assert a["uid"] == b["uid"] and a["y"] == b["y"] and b["y"].dtype == np.int64
        np.testing.assert_array_equal(a["h_a"], b["h_a"])
        np.testing.assert_array_equal(a["h_t"], b["h_t"])
    items = [td[i] for i in range(5)]
    _same(j_stack([jd[i] for i in range(5)]), stack_utter_batch(items))


@pytest.mark.parametrize("shuffle,drop_last,bs", [(True, True, 4), (False, False, 4),
                                                  (True, False, 7)])
def test_utter_batcher_matches_jax(tmp_path, shuffle, drop_last, bs):
    """The same batches in the same order over two epochs: shuffle order,
    ``drop_last``, the tail repeated to the batch with ``n_valid``, and the
    ``[B, 1, d]`` layout with all-valid masks."""
    csv_path, audio_dir, text_dir, _ = _corpus(tmp_path)
    df = pd.read_csv(csv_path)
    rows, cols = read_index_csv(csv_path)
    label2id = {lab: i for i, lab in enumerate(sorted(set(df["label"])))}
    jd = JDataset(df[df["split"] == "train"], audio_dir, text_dir, label2id=label2id)
    td = TDataset([r for r in rows if r["split"] == "train"], audio_dir, text_dir,
                  label2id=label2id, columns=cols)
    kw = dict(shuffle=shuffle, seed=11, drop_last=drop_last, utter_level=True)
    jb, tb = JBatcher(jd, bs, **kw), TBatcher(td, bs, **kw)
    assert len(tb) == len(jb)
    n = 0
    for _ in range(2):
        for a, b in zip(jb, tb, strict=True):
            _same(a, b)
            assert b["h_a"].shape == (bs, 1, 8) and b["mask_a"].shape == (bs, 1)
            assert not b["mask_a"].any() and not b["mask_t"].any()
            n += 1
    assert n == 2 * len(tb)
