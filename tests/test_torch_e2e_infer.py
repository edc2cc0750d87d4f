"""PyTorch port: the end-to-end inference CLI (hriemo_torch/infer/
e2e_infer.py) against the JAX CLI on the fake IEMOCAP corpus of
tests/test_dataprep.py, through the frontends' HF bridges, the WordPiece
tokenizer and a fusion checkpoint written from the JAX parameters, on the
CPU."""

import numpy as np
import pytest
import torch

from hriemo.infer import e2e_infer as JE2E
from hriemo.models import FusionWithEmotionDecoder
from hriemo.utils import checkpoint as JC
from hriemo_torch.dataprep import iemocap_index as TI
from hriemo_torch.infer import e2e_infer as TE2E

from test_dataprep import make_fake_iemocap
from test_pretrained_golden import TINY_BERT, TINY_WAVLM
from torch_port_helpers import FP32_TOL, assert_kernel_close, one_torch_thread  # noqa: F401

E2E_VOCAB = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + list("abcdefghijklmnopqrstuvwxyz")
             + ["##" + c for c in "aeiost"] + ["hi", "there", "friend", "hello", "world",
                                                "noise", "<", ">", "(", ")", "2"])
FUSION_ARGS = dict(d_model=32, n_heads=4, num_layers_fusion=2, num_layers_decoder=2,
                   beta_hidden=16, dropout=0.1)


@pytest.fixture(scope="module")
def e2e_inputs(tmp_path_factory):
    from transformers import BertConfig as HFBertConfig, BertModel
    from transformers import WavLMConfig as HFWavLMConfig, WavLMModel

    root = tmp_path_factory.mktemp("e2e")
    idx = TI.main(["--base", str(make_fake_iemocap(root / "iemocap")),
                   "--out_dir", str(root / "data")])
    torch.manual_seed(1)
    torch.save(WavLMModel(HFWavLMConfig(
        **TINY_WAVLM, feat_extract_norm="group", do_stable_layer_norm=False, conv_bias=False,
        mask_time_prob=0.0)).state_dict(), root / "wavlm.pt")
    torch.save(BertModel(HFBertConfig(**TINY_BERT)).state_dict(), root / "bert.pt")
    assert len(E2E_VOCAB) <= TINY_BERT["vocab_size"]
    (root / "vocab.txt").write_text("\n".join(E2E_VOCAB) + "\n")
    jf = FusionWithEmotionDecoder(num_emotions=4, **FUSION_ARGS)
    JC.save_torch_checkpoint(str(root / "fusion.pt"), {
        "model_state_dict": JC.state_dict_from_params(jf.params), "args": dict(FUSION_ARGS)})
    argv = ["--index_csv", str(idx), "--tiny", "--wavlm_state_dict", str(root / "wavlm.pt"),
            "--bert_state_dict", str(root / "bert.pt"), "--fusion_ckpt", str(root / "fusion.pt"),
            "--amp_dtype", "off", "--batch_size", "4"]
    return root, argv


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
