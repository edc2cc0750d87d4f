"""PyTorch port: the pretrained-bridge runbook
(hriemo_torch/tools/validate_pretrained_bridges.py) on random HF state
dicts at tiny widths, as tests/test_pretrained_golden.py drives the JAX
tool: the bridges against HF's forward, and the int8 report against the
JAX package's (tools/validate_pretrained_bridges.py) (CPU; ``transformers``
builds the HF models)."""

import json

import numpy as np
import pytest
import torch

pytest.importorskip("transformers")

import tools.validate_pretrained_bridges as JVT  # noqa: E402
from hriemo_torch.tools import validate_pretrained_bridges as TVT  # noqa: E402

from test_pretrained_golden import TINY_BERT, TINY_WAVLM  # noqa: E402
from torch_port_helpers import one_torch_thread  # noqa: E402,F401

# 256 wide: the int8 report's min_dim quantizes WavLM, BERT and the fusion model
WIDE = dict(hidden_size=256, num_hidden_layers=1, intermediate_size=512)


_PROBES = JVT._probe_inputs


@pytest.fixture(autouse=True)
def short_probes(monkeypatch):
    """Both tools' probe clips cut from 1 s to a quarter (the masks at 11/16
    and 7/16 of the clip, as the tools place them), for the CPU's time."""
    def probes(kind: str, seed: int = 0):
        x, mask = _PROBES(kind, seed)
        if kind == "wavlm":
            x, mask = x[:, :4000], np.ones((3, 4000), np.int64)
            mask[1, 2750:] = 0
            mask[2, 1750:] = 0
        return x, mask

    for mod in (JVT, TVT):
        monkeypatch.setattr(mod, "_probe_inputs", probes)


def _state_dicts(root, wide: bool):
    from transformers import BertConfig, BertModel, WavLMConfig, WavLMModel

    wide_kw = WIDE if wide else {}
    wcfg, bcfg = dict(TINY_WAVLM, **wide_kw), dict(TINY_BERT, **wide_kw)
    torch.manual_seed(0)
    wavlm = WavLMModel(WavLMConfig(
        **wcfg, feat_extract_norm="group", do_stable_layer_norm=False, conv_bias=False,
        hidden_dropout=0.0, activation_dropout=0.0, attention_dropout=0.0,
        feat_proj_dropout=0.0, layerdrop=0.0, mask_time_prob=0.0,
        mask_feature_prob=0.0)).eval().state_dict()
    torch.manual_seed(1)
    bert = BertModel(BertConfig(**bcfg, hidden_act="gelu", attention_probs_dropout_prob=0.0,
                                hidden_dropout_prob=0.0)).eval().state_dict()
    paths = root / f"wavlm_{wide}.bin", root / f"bert_{wide}.bin"
    torch.save(wavlm, paths[0])
    torch.save(bert, paths[1])
    return paths, json.dumps(wcfg), json.dumps(bcfg)


def test_runbook_matches_hf_and_round_trips(tmp_path):
    """Both bridges within 2e-4 of HF's forward (the tool's own oracle),
    through ``main`` with ``--device cpu``; the golden file passes its own
    ``--check-golden`` and fails one whose fingerprint was moved."""
    (wp, bp), wcfg, bcfg = _state_dicts(tmp_path, wide=False)
    argv = ["--wavlm", str(wp), "--bert", str(bp), "--wavlm-config", wcfg,
            "--bert-config", bcfg, "--device", "cpu"]
    golden = tmp_path / "golden.json"
    assert TVT.main(argv + ["--out", str(golden)]) == 0
    got = json.loads(golden.read_text())["results"]
    for name in ("wavlm", "bert"):
        assert got[name]["hf_max_delta_valid"] <= 2e-4
        assert got[name]["fingerprint"]["shape"][0] == 3
    assert got["wavlm"]["frame_mask_sums"][0] > got["wavlm"]["frame_mask_sums"][2] > 0
    assert TVT.main(argv + ["--check-golden", str(golden)]) == 0
    moved = json.loads(golden.read_text())
    moved["results"]["bert"]["fingerprint"]["mean"] += 0.01
    golden.write_text(json.dumps(moved))
    with pytest.raises(AssertionError, match="bert: golden mean"):
        TVT.main(argv + ["--check-golden", str(golden)])


def test_int8_report_names_match_jax(tmp_path):
    """``--int8-report`` at 256 wide: the report's layer names and
    quantized-layer count equal the JAX runbook's (its fusion model is
    random in both, from each package's own seed)."""
    (wp, bp), wcfg, bcfg = _state_dicts(tmp_path, wide=True)
    out = tmp_path / "int8.json"
    assert TVT.main(["--wavlm", str(wp), "--bert", str(bp), "--wavlm-config", wcfg,
                     "--bert-config", bcfg, "--int8-report", str(out),
                     "--int8-envelope", "1.0", "--no-hf-compare", "--device", "cpu"]) == 0
    got = json.loads(out.read_text())
    ref = JVT.int8_report(torch.load(wp, weights_only=True), torch.load(bp, weights_only=True),
                          None, 1.0, json.loads(wcfg), json.loads(bcfg))
    assert got["n_quantized_layers"] == ref["n_quantized_layers"] > 10
    assert set(got["activation_amax"]) == set(ref["activation_amax"])
    assert got["within_envelope"] and got["reverted_layers"] == []
    assert got["fusion_source"].startswith("fusion: random")
    assert 0 < got["deltas_full_int8"]["probs"] < 0.05
