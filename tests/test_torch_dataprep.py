"""PyTorch port: IEMOCAP index, feature extraction and integrity
(hriemo_torch/dataprep) against the JAX package's CLIs on the same fake
corpus (tests/test_dataprep.py::make_fake_iemocap), tiny fp32 frontends
with the JAX weights carried across, on the CPU."""

import types

import numpy as np
import pytest
import torch

from hriemo.data import load_feature, load_utter_feature
from hriemo.dataprep import extract_iemocap as JE
from hriemo.dataprep import iemocap_index as JI
from hriemo.frontends import BertConfig, BertEncoder, WavLMConfig, WavLMEncoder
import hriemo_torch.frontends as TF
from hriemo_torch.dataprep import extract_iemocap as TE
from hriemo_torch.dataprep import iemocap_index as TI
from hriemo_torch.dataprep.integrity import analyze_lengths, check_integrity

from test_dataprep import make_fake_iemocap
from torch_port_helpers import one_torch_thread, port, same_config  # noqa: F401

# the encoders' fp32 tolerance (tests/test_torch_frontends.py)
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = make_fake_iemocap(tmp_path_factory.mktemp("iemocap"))
    jax_dir, port_dir = tmp_path_factory.mktemp("jax_index"), tmp_path_factory.mktemp("index")
    JI.main(["--base", str(root), "--out_dir", str(jax_dir)])
    idx = TI.main(["--base", str(root), "--out_dir", str(port_dir)])
    return jax_dir, port_dir, idx


def test_index_csv_equals_jax_builder(corpus):
    jax_dir, port_dir, idx = corpus
    for name in ("iemocap_index.csv", "iemocap_index_splits.csv"):
        assert (port_dir / name).read_text() == (jax_dir / name).read_text(), name
    rows = TI.read_csv(idx)
    assert len(rows) == 7 and {r["split"] for r in rows} == {"train", "val", "test"}


def _args(modality, level, out_dir, idx, fmt="npz"):
    argv = ["--modality", modality, "--level", level, "--index_csv", str(idx),
            "--out_dir", str(out_dir), "--tiny", "--random_init", "--batch_size", "4",
            "--max_seconds", "0.5", "--max_len_text", "16", "--fmt", fmt]
    return argv, TE.parse_args(argv + ["--device", "cpu"])


@pytest.mark.parametrize("modality", ["audio", "text"])
def test_extraction_matches_jax_cli(corpus, tmp_path, modality):
    """Seq and utter level, npz and pt: the port's files (read with the JAX
    package's loaders) against the JAX CLI's, same weights."""
    _, _, idx = corpus
    if modality == "audio":
        jm = WavLMEncoder(WavLMConfig.tiny())  # the JAX CLI's --random_init weights
        tm = port(jm, TF.WavLMEncoder(same_config(TF.WavLMConfig, WavLMConfig.tiny())))
        run = TE.extract_audio
    else:
        jm = BertEncoder(BertConfig.tiny())
        tm = port(jm, TF.BertEncoder(same_config(TF.BertConfig, BertConfig.tiny())))
        run = TE.extract_text
    rows = TI.read_csv(idx)
    for level, fmt in (("seq", "npz"), ("utter", "pt")):
        argv, args = _args(modality, level, tmp_path / f"port_{level}", idx, fmt)
        JE.main([a.replace("port_", "jax_") for a in argv])
        (tmp_path / f"port_{level}").mkdir()
        stats = run(args, rows, tmp_path / f"port_{level}", model=tm)
        assert stats["count"] == len(rows)
        for r in rows:
            name = f"{r['utter_id']}.{fmt}"
            if level == "seq":
                (got, got_mask), (ref, ref_mask) = (load_feature(tmp_path / f"{d}_seq" / name)
                                                    for d in ("port", "jax"))
                np.testing.assert_array_equal(got_mask, ref_mask)
            else:
                got, ref = (load_utter_feature(tmp_path / f"{d}_utter" / name)
                            for d in ("port", "jax"))
            assert got.shape == ref.shape and np.isfinite(got).all()
            np.testing.assert_allclose(got, ref, **TOL)


def test_cli_chain_and_integrity(corpus, tmp_path):
    """index -> extract (the port's CLI, its own random weights) ->
    integrity, all on the CPU; the card is the default device."""
    _, _, idx = corpus
    dirs = {}
    for modality in ("audio", "text"):
        argv, _ = _args(modality, "seq", tmp_path / modality, idx)
        dirs[modality] = TE.main(argv + ["--device", "cpu"])
    report = check_integrity(str(idx), str(dirs["audio"]), str(dirs["text"]))
    assert report["ok"], report
    assert report["shapes"]["audio"]["dims"] == [32] and report["csv_missing_audio"] == 0
    stats = analyze_lengths(str(dirs["audio"]), str(tmp_path / "length_stats.csv"))
    assert stats["count"] == 7 and stats["max"] == 399  # 0.5 s at the tiny strides
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TE.main(argv)
    # pretrained BERT weights without --vocab_file: the hash-tokenizer quality gate
    torch.save(TF.BertEncoder(TF.BertConfig.tiny()).state_dict(), tmp_path / "bert.pt")
    text_argv, _ = _args("text", "seq", tmp_path / "gate", idx)
    with pytest.raises(SystemExit, match="allow_hash_tokenizer"):
        TE.main([a for a in text_argv if a != "--random_init"]
                + ["--device", "cpu", "--bert_state_dict", str(tmp_path / "bert.pt")])
    with pytest.raises(SystemExit, match="random_init"):
        TE.extract_text(types.SimpleNamespace(tiny=True, random_init=False,
                                              bert_state_dict=None), [], tmp_path)


@pytest.fixture(scope="module")
def local_weights(tmp_path_factory):
    """HF state dicts of the tiny frontends at random init and a WordPiece
    vocabulary of the fake corpus's transcripts, as local files."""
    from transformers import BertConfig as HFBertConfig, BertModel
    from transformers import WavLMConfig as HFWavLMConfig, WavLMModel

    from test_pretrained_golden import TINY_BERT, TINY_WAVLM

    root = tmp_path_factory.mktemp("weights")
    torch.manual_seed(2)
    torch.save(WavLMModel(HFWavLMConfig(
        **TINY_WAVLM, feat_extract_norm="group", do_stable_layer_norm=False, conv_bias=False,
        mask_time_prob=0.0)).state_dict(), root / "wavlm.pt")
    torch.save({"model_state_dict": BertModel(HFBertConfig(**TINY_BERT)).state_dict()},
               root / "bert.pt")
    (root / "vocab.txt").write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "hi", "there", "friend", "hello", "world",
         "<", ">", "(", ")", "2", "no", "##ise"]) + "\n")
    return root


@pytest.mark.parametrize("modality", ["audio", "text"])
def test_extraction_with_local_weights_matches_jax_cli(corpus, local_weights, tmp_path,
                                                       modality):
    """Both CLIs with the same local HF state dicts (the BERT one inside a
    checkpoint's ``model_state_dict``) and vocabulary: the same features."""
    _, _, idx = corpus
    flag = "--wavlm_state_dict" if modality == "audio" else "--bert_state_dict"
    name = "wavlm.pt" if modality == "audio" else "bert.pt"
    argv, _ = _args(modality, "seq", tmp_path / "port_seq", idx)
    argv = [a for a in argv if a != "--random_init"] + [
        flag, str(local_weights / name), "--vocab_file", str(local_weights / "vocab.txt")]
    JE.main([a.replace("port_", "jax_") for a in argv])
    TE.main(argv + ["--device", "cpu"])
    for r in TI.read_csv(idx):
        (got, got_mask), (ref, ref_mask) = (load_feature(tmp_path / d / f"{r['utter_id']}.npz")
                                            for d in ("port_seq", "jax_seq"))
        np.testing.assert_array_equal(got_mask, ref_mask)
        assert got.shape == ref.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, **TOL)
    if modality == "text":  # the WordPiece ids reached BERT: more than [CLS] and [SEP]
        assert got_mask.sum() > 2
