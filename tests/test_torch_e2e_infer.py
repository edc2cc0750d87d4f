"""PyTorch port: the end-to-end inference CLI (hriemo_torch/infer/
e2e_infer.py) against the JAX CLI on the fake IEMOCAP corpus of
tests/test_dataprep.py, through the frontends' HF bridges, the WordPiece
tokenizer and a fusion checkpoint written from the JAX parameters, on the
CPU. The ``--int8`` case at the tiny widths quantizes nothing (every Linear
is below ``min_dim = 256``), so a second case runs ``--int8`` with 256-wide
frontends and fusion model, where both packages quantize."""

import dataclasses

import numpy as np
import pytest
import torch

import hriemo.frontends as JFront
from hriemo.infer import e2e_infer as JE2E
from hriemo.models import FusionWithEmotionDecoder
from hriemo.ops import quant as JQ
from hriemo.utils import checkpoint as JC
import hriemo_torch.frontends as TFront
from hriemo_torch.dataprep import iemocap_index as TI
from hriemo_torch.infer import e2e_infer as TE2E
from hriemo_torch.infer import streaming as TS
from hriemo_torch.ops import quant as TQ

from test_dataprep import make_fake_iemocap
from test_pretrained_golden import TINY_BERT, TINY_WAVLM
from torch_port_helpers import FP32_TOL, assert_kernel_close, one_torch_thread  # noqa: F401

E2E_VOCAB = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + list("abcdefghijklmnopqrstuvwxyz")
             + ["##" + c for c in "aeiost"] + ["hi", "there", "friend", "hello", "world",
                                                "noise", "<", ">", "(", ")", "2"])
FUSION_ARGS = dict(d_model=32, n_heads=4, num_layers_fusion=2, num_layers_decoder=2,
                   beta_hidden=16, dropout=0.1)
# The W8A8 case: every hidden and intermediate width at min_dim = 256 or
# above, one layer each, so that the frontends' and the fusion stack's
# Linears and MHAs quantize (the conv stack's 16 channels stay float)
WIDE = dict(hidden_size=256, num_hidden_layers=1, intermediate_size=512)
WIDE_WAVLM = dict(TINY_WAVLM, **WIDE)
WIDE_BERT = dict(TINY_BERT, **WIDE)
WIDE_FUSION = dict(FUSION_ARGS, d_model=256, num_layers_fusion=1, num_layers_decoder=1,
                   beta_hidden=256)


def _write_inputs(root, wavlm, bert, fusion):
    """The fake corpus's index, HF state dicts at the given widths, the
    vocabulary and a fusion checkpoint from the JAX parameters; returns the
    CLI arguments both packages take."""
    from transformers import BertConfig as HFBertConfig, BertModel
    from transformers import WavLMConfig as HFWavLMConfig, WavLMModel

    idx = TI.main(["--base", str(make_fake_iemocap(root / "iemocap")),
                   "--out_dir", str(root / "data")])
    torch.manual_seed(1)
    torch.save(WavLMModel(HFWavLMConfig(
        **wavlm, feat_extract_norm="group", do_stable_layer_norm=False, conv_bias=False,
        mask_time_prob=0.0)).state_dict(), root / "wavlm.pt")
    torch.save(BertModel(HFBertConfig(**bert)).state_dict(), root / "bert.pt")
    assert len(E2E_VOCAB) <= bert["vocab_size"]
    (root / "vocab.txt").write_text("\n".join(E2E_VOCAB) + "\n")
    jf = FusionWithEmotionDecoder(num_emotions=4, **fusion)
    JC.save_torch_checkpoint(str(root / "fusion.pt"), {
        "model_state_dict": JC.state_dict_from_params(jf.params), "args": dict(fusion)})
    return ["--index_csv", str(idx), "--tiny", "--wavlm_state_dict", str(root / "wavlm.pt"),
            "--bert_state_dict", str(root / "bert.pt"), "--fusion_ckpt", str(root / "fusion.pt"),
            "--amp_dtype", "off", "--batch_size", "4"]


@pytest.fixture(scope="module")
def e2e_inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("e2e")
    return root, _write_inputs(root, TINY_WAVLM, TINY_BERT, FUSION_ARGS)


def _e2e_outputs(out_dir, split="all"):
    uids = (out_dir / f"{split}_uids.txt").read_text().split("\n")
    probs = np.load(out_dir / f"{split}_y_prob.npy")
    beta = np.load(out_dir / f"{split}_beta_mean.npy")
    assert len(uids) == len(probs) == len(beta)
    return {u: (p, b) for u, p, b in zip(uids, probs, beta)}


@pytest.mark.parametrize("int8", [False, True])
def test_e2e_infer_matches_jax_cli(e2e_inputs, int8):
    """Both CLIs on the fake corpus with the same HF state dicts, vocabulary
    and fusion checkpoint; probabilities and beta matched by uid, at fp32
    (``--amp_dtype off``) and W8A8 (``--int8``)."""
    root, argv = e2e_inputs
    extra = ["--vocab_file", str(root / "vocab.txt")] + (["--int8"] if int8 else [])
    tag = "int8" if int8 else "fp32"
    JE2E.main(argv + extra + ["--out_dir", str(root / f"jax_{tag}")])
    TE2E.main(argv + extra + ["--out_dir", str(root / f"port_{tag}"), "--device", "cpu"])
    ref, got = _e2e_outputs(root / f"jax_{tag}"), _e2e_outputs(root / f"port_{tag}")
    assert set(got) == set(ref) and len(got) == 7
    for part in (0, 1):
        g = np.stack([got[u][part] for u in sorted(ref)])
        r = np.stack([ref[u][part] for u in sorted(ref)])
        assert np.isfinite(g).all()
        if int8:
            assert_kernel_close(g, r)
        else:
            np.testing.assert_allclose(g, r, atol=FP32_TOL)
    probs = np.stack([got[u][0] for u in got])
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)


def test_e2e_infer_int8_quantizes_and_matches_jax_cli(tmp_path, monkeypatch):
    """``--int8`` at widths where W8A8 applies: both CLIs' ``--tiny``
    configurations widened to 256 (one layer, intermediate 512), the fusion
    model at d=256; each package must quantize layers of all three models,
    and the probabilities and beta match at the kernel-path tolerance that
    tests/test_torch_streaming.py holds the int8 pipeline to at d=256."""
    argv = _write_inputs(tmp_path, WIDE_WAVLM, WIDE_BERT, WIDE_FUSION)
    for pkg in (JFront, TFront):
        for cfg, wide in ((pkg.WavLMConfig, WIDE_WAVLM), (pkg.BertConfig, WIDE_BERT)):
            keep = {k: v for k, v in wide.items()
                    if k in {f.name for f in dataclasses.fields(cfg)}}
            monkeypatch.setattr(cfg, "tiny", classmethod(lambda c, _k=keep, **kw: c(**_k, **kw)))
    counts = {"jax": [], "port": []}
    jq = JQ.quantize_tree_for_serving
    monkeypatch.setattr(JQ, "quantize_tree_for_serving",
                        lambda p, *a, **k: counts["jax"].append(JQ.count_quantized(
                            q := jq(p, *a, **k))) or q)
    tq = TS.quantize_for_serving
    monkeypatch.setattr(TS, "quantize_for_serving",
                        lambda m, *a, **k: counts["port"].append(TQ.count_quantized(
                            q := tq(m, *a, **k))) or q)
    extra = ["--vocab_file", str(tmp_path / "vocab.txt"), "--int8"]
    JE2E.main(argv + extra + ["--out_dir", str(tmp_path / "jax")])
    TE2E.main(argv + extra + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    # WavLM, BERT and the fusion model, each with int8 layers, in both packages
    assert len(counts["jax"]) == len(counts["port"]) == 3, counts
    assert min(counts["jax"]) > 0 and min(counts["port"]) > 0, counts
    ref, got = _e2e_outputs(tmp_path / "jax"), _e2e_outputs(tmp_path / "port")
    assert set(got) == set(ref) and len(got) == 7
    for part in (0, 1):
        g = np.stack([got[u][part] for u in sorted(ref)])
        r = np.stack([ref[u][part] for u in sorted(ref)])
        assert np.isfinite(g).all()
        assert_kernel_close(g, r)


@pytest.mark.parametrize("cli", [JE2E, TE2E], ids=["jax", "port"])
def test_e2e_quality_gate(e2e_inputs, cli):
    """Pretrained weights without ``--vocab_file`` exit in both packages."""
    root, argv = e2e_inputs
    device = ["--device", "cpu"] if cli is TE2E else []
    with pytest.raises(SystemExit, match="hash tokenizer"):
        cli.main(argv + ["--out_dir", str(root / "gate")] + device)



def test_e2e_defaults_to_the_card(e2e_inputs):
    """Without ``--device cpu`` the CLI runs on the card and raises without one."""
    root, argv = e2e_inputs
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TE2E.main(argv + ["--vocab_file", str(root / "vocab.txt"), "--out_dir", "unused"])
