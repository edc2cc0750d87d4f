"""PyTorch port: the HF state-dict bridges of the frontends
(``from_torch_state_dict``) against the JAX package's bridges and HF's own
forward, and the port's WordPiece tokenizer (hriemo_torch/dataprep/
tokenization.py) against ``BertTokenizerFast``. The HF models are built
at random init from tiny configs equal to the port's ``tiny()`` ones
(tests/test_frontends.py), and the vocabulary is written by the test."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hriemo.frontends import BertConfig, BertEncoder, WavLMConfig, WavLMEncoder
import hriemo_torch.frontends as TF
from hriemo_torch.dataprep.tokenization import WordPieceTokenizer

from test_pretrained_golden import TINY_BERT, TINY_WAVLM, _swap_weight_norm_scheme
from torch_port_helpers import one_torch_thread  # noqa: F401

ATOL = 2e-4  # tests/test_frontends.py


@pytest.fixture(scope="module")
def wavlm_sd():
    from transformers import WavLMConfig as HFWavLMConfig, WavLMModel

    torch.manual_seed(1)
    hf = WavLMModel(HFWavLMConfig(
        **TINY_WAVLM, feat_extract_norm="group", do_stable_layer_norm=False,
        conv_bias=False, hidden_dropout=0.0, activation_dropout=0.0, attention_dropout=0.0,
        feat_proj_dropout=0.0, layerdrop=0.0, mask_time_prob=0.0,
        mask_feature_prob=0.0)).eval()
    return hf, {f"wavlm.{k}": v for k, v in hf.state_dict().items()}


@pytest.fixture(scope="module")
def bert_sd():
    from transformers import BertConfig as HFBertConfig, BertModel

    torch.manual_seed(0)
    hf = BertModel(HFBertConfig(**TINY_BERT, hidden_act="gelu",
                                attention_probs_dropout_prob=0.0,
                                hidden_dropout_prob=0.0)).eval()
    return hf, {f"bert.{k}": v for k, v in hf.state_dict().items()}


def _wav_inputs(masked):
    rng = np.random.default_rng(3)
    wav = rng.standard_normal((3, 800)).astype(np.float32) * 0.1
    mask = np.ones((3, 800), np.int64)
    if masked:
        mask[1, 500:] = 0
        mask[2, 300:] = 0
    return wav, mask


@pytest.mark.parametrize("masked", [False, True])
def test_wavlm_bridge_matches_hf_and_jax(wavlm_sd, masked):
    """The prefixed HF state dict (both weight-norm namings' source) loads
    into the port; valid frames agree with HF's forward and the JAX
    bridge's."""
    hf, sd = wavlm_sd
    port = TF.WavLMEncoder(TF.WavLMConfig.tiny()).from_torch_state_dict(sd).eval()
    jm = WavLMEncoder(WavLMConfig.tiny()).from_torch_state_dict(sd)
    wav, mask = _wav_inputs(masked)
    with torch.no_grad():
        ref = hf(input_values=torch.tensor(wav), attention_mask=torch.tensor(mask))
        got, frames = port(torch.tensor(wav), torch.tensor(mask))
    jseq, jmask = jm(jnp.asarray(wav), jnp.asarray(mask))
    np.testing.assert_array_equal(frames.numpy(), np.asarray(jmask))
    for b in range(3):
        n = int(frames[b].sum())
        np.testing.assert_allclose(got[b, :n].numpy(), ref.last_hidden_state[b, :n].numpy(),
                                   atol=ATOL)
        np.testing.assert_allclose(got[b, :n].numpy(), np.asarray(jseq)[b, :n], atol=ATOL)


@pytest.mark.parametrize("masked", [False, True])
def test_bert_bridge_matches_hf_and_jax(bert_sd, masked):
    hf, sd = bert_sd
    port = TF.BertEncoder(TF.BertConfig.tiny()).from_torch_state_dict(sd).eval()
    jm = BertEncoder(BertConfig.tiny()).from_torch_state_dict(sd)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 99, size=(3, 12))
    mask = np.ones((3, 12), np.int64)
    if masked:
        mask[1, 8:] = 0
        mask[2, 5:] = 0
    with torch.no_grad():
        ref = hf(input_ids=torch.tensor(ids), attention_mask=torch.tensor(mask))
        got, pooled = port(torch.tensor(ids), torch.tensor(mask))
    jseq, jpool = jm(jnp.asarray(ids), jnp.asarray(mask))
    for b in range(3):
        n = int(mask[b].sum())
        np.testing.assert_allclose(got[b, :n].numpy(), ref.last_hidden_state[b, :n].numpy(),
                                   atol=ATOL)
        np.testing.assert_allclose(got[b, :n].numpy(), np.asarray(jseq)[b, :n], atol=ATOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jpool), atol=ATOL)


def test_both_weight_norm_namings_load_identically(wavlm_sd):
    """``parametrizations.weight.original0/1`` and ``weight_g/weight_v`` fold
    to the same positional-conv weight, the JAX bridge's."""
    _, sd = wavlm_sd
    cfg = TF.WavLMConfig.tiny()
    a = TF.WavLMEncoder(cfg).from_torch_state_dict(sd).state_dict()
    b = TF.WavLMEncoder(cfg).from_torch_state_dict(_swap_weight_norm_scheme(sd)).state_dict()
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), atol=1e-6, err_msg=k)
    jm = WavLMEncoder(WavLMConfig.tiny()).from_torch_state_dict(sd)
    name = "encoder.pos_conv_embed.conv.weight"
    np.testing.assert_array_equal(
        a[name].numpy(), np.asarray(jm.params["encoder"]["pos_conv_embed"]["conv"]["weight"]))


@pytest.mark.parametrize("frontend", ["wavlm", "bert"])
@pytest.mark.parametrize("fault", ["missing", "unexpected", "shape"])
def test_bridge_is_strict(wavlm_sd, bert_sd, frontend, fault):
    _, sd = wavlm_sd if frontend == "wavlm" else bert_sd
    sd = dict(sd)
    name = next(k for k in sd if k.endswith("layer_norm.weight") or k.endswith("LayerNorm.weight"))
    if fault == "missing":
        del sd[name]
    elif fault == "unexpected":
        sd[name.replace("weight", "scale")] = sd[name]
    else:
        sd[name] = torch.zeros(3)
    module = (TF.WavLMEncoder(TF.WavLMConfig.tiny()) if frontend == "wavlm"
              else TF.BertEncoder(TF.BertConfig.tiny()))
    with pytest.raises(ValueError if fault == "shape" else KeyError):
        module.from_torch_state_dict(sd)


# --------------------------------------------------------------- tokenizer

VOCAB = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
         + list("abcdefghijklmnopqrstuvwxyz0123456789")
         + ["##" + c for c in "abcdefghijklmnopqrstuvwxyz"]
         + ["hello", "world", "happ", "##y", "##iness", "un", "##believ", "##able", "cafe",
            "naive", ".", ",", "!", "?", "'", "-", "中", "国", "¿", "«", "»", "—", "…", "σ",
            "ς", "ο", "##ς", "$", "^", "`", "|", "+", "<", "i", "##̇", "丽"])

TEXTS = [
    "", " ", "   leading and trailing   ", "Hello, World!", "HAPPINESS unbelievable",
    "café Café CAFÉ naïve résumé", "中国人 中国", "a中b", "a㐀b", "p\U0002F800q",
    "a\U0002B820b gap ext", "¿Qué? «hola» — dijo…", "tab\there\nnew\rline",
    "ctrl\x00\x01\x07\x1b char\x7f", "x\x0by\x0cz\x1cw\x85v", "zero​width",
    "� replacement", "soft\xadhyphen", "nbsp\xa0space　ideo line para",
    "a" * 101, "b" * 100, "ab" * 70, "xyz qqq", "ΟΔΟΣ σοφός", "İstanbul",
    "$5 + 3 < 4 ^ 2 | `x`", "dots...and---dashes", "hello [MASK] world [CLS][SEP]",
    "[mask] lower", "a[SEP]b", "[UNK][PAD]", "emoji \U0001F600 text", "ﬁ ligature",
    "half-width ｶﾀｶﾅ", "Ⅻ roman ǅ", "numbers 123 4567", "hello " * 80,
]


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    path.write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
    return path


@pytest.mark.parametrize("max_length", [8, 128])
def test_wordpiece_equals_bert_tokenizer_fast(vocab_file, max_length):
    """Every test string, ids and mask equal to ``BertTokenizerFast``'s, with
    the keys and dtypes the CLIs read."""
    from transformers import BertTokenizerFast

    ref = BertTokenizerFast(vocab_file=str(vocab_file), do_lower_case=True)(
        TEXTS, max_length=max_length, padding="max_length", truncation=True,
        return_tensors="np")
    got = WordPieceTokenizer(vocab_file)(TEXTS, max_length=max_length, padding="max_length",
                                         truncation=True, return_tensors="np")
    assert len(TEXTS) >= 30
    for key in ("input_ids", "attention_mask", "token_type_ids"):
        assert got[key].dtype == ref[key].dtype and got[key].shape == ref[key].shape, key
        for i, text in enumerate(TEXTS):
            np.testing.assert_array_equal(got[key][i], ref[key][i], err_msg=repr(text))


def test_wordpiece_vocab_needs_special_tokens(tmp_path):
    path = tmp_path / "vocab.txt"
    path.write_text("[PAD]\n[UNK]\nhello\n")
    with pytest.raises(ValueError, match="CLS"):
        WordPieceTokenizer(path)
