#!/usr/bin/env python3
"""Pretrained-weight validation of the port's WavLM and BERT bridges, and
the int8 numerics report on real weights (port of
``tools/validate_pretrained_bridges.py``).

A runbook for when ``microsoft/wavlm-base-plus`` and ``bert-base-uncased``
state dicts are on local disk; it fetches nothing. It

1. loads each state dict through ``from_torch_state_dict``;
2. runs fixed probe inputs (seed 0) through the port's frontend in fp32;
3. where ``transformers`` is installed, holds the output against HF's
   forward to ``--atol`` on the valid positions (skipped, and said so,
   where it is not, as on a card's machine without it);
4. writes fingerprints of the outputs (``--out``) or checks them against an
   earlier file (``--check-golden``);
5. with ``--int8-report OUT_JSON``, runs :func:`hriemo_torch.ops.quant.
   int8_numerics_report` on WavLM, BERT and the fusion model (from
   ``--fusion-ckpt``, else random at product widths): per-layer activation
   statistics, probability and beta deltas of the W8A8 tree against full
   precision, and the layers to keep in full precision
   (``quantize_for_serving(exclude=...)``) when the envelope is blown.

    python -m hriemo_torch.tools.validate_pretrained_bridges \\
        --wavlm /weights/wavlm-base-plus/pytorch_model.bin \\
        --bert /weights/bert-base-uncased/pytorch_model.bin \\
        --int8-report int8_report.json --out golden.json

``--device`` is ``cuda`` by default (raises without a card); the report's
deltas then run through the kernels.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import sys

import numpy as np
import torch

ATOL_DEFAULT = 2e-4


def _load_state_dict(path: str) -> dict:
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return load_file(path)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj and all(
            hasattr(v, "shape") for v in obj["state_dict"].values()):
        return obj["state_dict"]
    return obj


def _fingerprint(arr) -> dict:
    """Stable summary of an activation tensor for the golden file."""
    a = np.asarray(arr, np.float64)
    return {
        "shape": list(a.shape),
        "mean": float(a.mean()),
        "std": float(a.std()),
        "absmax": float(np.abs(a).max()),
        "first8": [float(v) for v in a.ravel()[:8]],
        # the fp32 values rounded to 1e-3: survives benign drift, catches real faults
        "sha256_r3": hashlib.sha256(np.round(a, 3).astype(np.float32).tobytes()).hexdigest(),
    }


def _probe_inputs(kind: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    if kind == "wavlm":
        wav = (rng.standard_normal((3, 16000)) * 0.1).astype(np.float32)
        mask = np.ones((3, 16000), np.int64)
        mask[1, 11000:] = 0
        mask[2, 7000:] = 0
        return wav, mask
    ids = rng.integers(0, 1000, size=(3, 24))
    mask = np.ones((3, 24), np.int64)
    mask[1, 16:] = 0
    mask[2, 9:] = 0
    return ids, mask


def _config(base, overrides: dict):
    return dataclasses.replace(base, **overrides) if overrides else base


def _valid_max_delta(got: np.ndarray, ref: np.ndarray, lengths) -> float:
    return max(float(np.abs(got[b, :n] - ref[b, :n]).max()) for b, n in enumerate(lengths))


def _hf_available() -> bool:
    import importlib.util

    return importlib.util.find_spec("transformers") is not None


def validate_wavlm(sd: dict, overrides: dict, atol: float, hf_compare: bool, device) -> dict:
    from ..frontends import WavLMConfig, WavLMEncoder

    cfg = _config(WavLMConfig.base_plus(), overrides)
    enc = WavLMEncoder(cfg).from_torch_state_dict(sd).to(device).eval()
    wav, mask = _probe_inputs("wavlm")
    with torch.no_grad():
        seq, fmask = enc(torch.from_numpy(wav).to(device), torch.from_numpy(mask).to(device))
    seq, fmask = seq.float().cpu().numpy(), fmask.cpu().numpy()
    report = {"fingerprint": _fingerprint(seq),
              "frame_mask_sums": [int(s) for s in fmask.sum(-1)]}
    if hf_compare and not _hf_available():
        report["hf_compare"] = "skipped: transformers is not installed"
    elif hf_compare:
        from transformers import WavLMConfig as HFWavLMConfig, WavLMModel

        hf_cfg = HFWavLMConfig(
            hidden_size=cfg.hidden_size, num_hidden_layers=cfg.num_hidden_layers,
            num_attention_heads=cfg.num_attention_heads,
            intermediate_size=cfg.intermediate_size, conv_dim=list(cfg.conv_dim),
            conv_kernel=list(cfg.conv_kernel), conv_stride=list(cfg.conv_stride),
            num_conv_pos_embeddings=cfg.num_conv_pos_embeddings,
            num_conv_pos_embedding_groups=cfg.num_conv_pos_embedding_groups,
            num_buckets=cfg.num_buckets, max_bucket_distance=cfg.max_bucket_distance,
            conv_bias=cfg.conv_bias, feat_extract_norm="group", do_stable_layer_norm=False,
            hidden_dropout=0.0, activation_dropout=0.0, attention_dropout=0.0,
            feat_proj_dropout=0.0, layerdrop=0.0, mask_time_prob=0.0, mask_feature_prob=0.0)
        hf = WavLMModel(hf_cfg).eval()
        hf.load_state_dict({k.removeprefix("wavlm."): v for k, v in sd.items()
                            if "adapter" not in k})
        with torch.no_grad():
            ref = hf(input_values=torch.from_numpy(wav),
                     attention_mask=torch.from_numpy(mask)).last_hidden_state.numpy()
        d = _valid_max_delta(seq, ref, fmask.sum(-1))
        report["hf_max_delta_valid"] = d
        if d > atol:
            raise AssertionError(f"WavLM bridge mismatch vs HF: max|d|={d:.2e} > atol={atol:g}")
    return report


def validate_bert(sd: dict, overrides: dict, atol: float, hf_compare: bool, device) -> dict:
    from ..frontends import BertConfig, BertEncoder

    cfg = _config(BertConfig.base_uncased(), overrides)
    enc = BertEncoder(cfg).from_torch_state_dict(sd).to(device).eval()
    ids, mask = _probe_inputs("bert")
    ids = ids % cfg.vocab_size
    with torch.no_grad():
        seq, pooled = enc(torch.from_numpy(ids).to(device), torch.from_numpy(mask).to(device))
    seq, pooled = seq.float().cpu().numpy(), pooled.float().cpu().numpy()
    report = {"fingerprint": _fingerprint(seq), "pooled": _fingerprint(pooled)}
    if hf_compare and not _hf_available():
        report["hf_compare"] = "skipped: transformers is not installed"
    elif hf_compare:
        from transformers import BertConfig as HFBertConfig, BertModel

        hf_cfg = HFBertConfig(
            vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
            num_hidden_layers=cfg.num_hidden_layers,
            num_attention_heads=cfg.num_attention_heads,
            intermediate_size=cfg.intermediate_size,
            max_position_embeddings=cfg.max_position_embeddings,
            type_vocab_size=cfg.type_vocab_size, hidden_act="gelu",
            attention_probs_dropout_prob=0.0, hidden_dropout_prob=0.0)
        hf = BertModel(hf_cfg).eval()
        # HF adds pooler.* that the port does not carry
        hf.load_state_dict({k.removeprefix("bert."): v for k, v in sd.items()
                            if not k.startswith("cls.")}, strict=False)
        with torch.no_grad():
            ref = hf(input_ids=torch.from_numpy(ids),
                     attention_mask=torch.from_numpy(mask)).last_hidden_state.numpy()
        d = _valid_max_delta(seq, ref, mask.sum(-1))
        report["hf_max_delta_valid"] = d
        if d > atol:
            raise AssertionError(f"BERT bridge mismatch vs HF: max|d|={d:.2e} > atol={atol:g}")
    return report


def serving_stack(wavlm, bert, fusion) -> torch.nn.Module:
    """The three models under the JAX runbook's tree names ``w``, ``b``,
    ``f``, so that the report names layers as the JAX one does."""
    return torch.nn.ModuleDict({"w": wavlm, "b": bert, "f": fusion})


def stack_apply(multi_label: bool = True):
    """``apply_fn`` of the report over :func:`serving_stack`: waveform,
    its mask, token ids and their mask to probabilities and beta."""

    def apply_fn(m, wav, wmask, ids, tmask):
        h_a, fmask = m["w"](wav, wmask)
        h_t, _ = m["b"](ids, tmask)
        logits, beta, _ = m["f"](h_a, h_t.to(h_a.dtype), fmask == 0, tmask == 0)
        logits = logits.float()
        probs = torch.sigmoid(logits) if multi_label else torch.softmax(logits, -1)
        return {"probs": probs, "beta": beta.float()}

    return apply_fn


def int8_report(wavlm_sd, bert_sd, fusion_ckpt: str | None, envelope: float,
                wavlm_overrides: dict, bert_overrides: dict, device, num_emotions: int = 4,
                multi_label: bool = True) -> dict:
    """The int8 report on the bridged state dicts and the fusion stack
    (``--fusion-ckpt``, a reference-layout ``best_*.pt``, else random at
    product widths), on the probe inputs, in fp32."""
    from ..frontends import BertConfig, BertEncoder, WavLMConfig, WavLMEncoder
    from ..models import FusionWithEmotionDecoder
    from ..ops.quant import int8_numerics_report
    from ..utils.checkpoint import load_torch_checkpoint

    wcfg = _config(WavLMConfig.base_plus(), wavlm_overrides)
    bcfg = _config(BertConfig.base_uncased(), bert_overrides)
    wavlm = WavLMEncoder(wcfg).from_torch_state_dict(wavlm_sd)
    bert = BertEncoder(bcfg).from_torch_state_dict(bert_sd)
    note = "fusion: random at product widths (no --fusion-ckpt)"
    fusion = FusionWithEmotionDecoder(d_model=wcfg.hidden_size, num_emotions=num_emotions,
                                      n_heads=8, num_layers_fusion=2, num_layers_decoder=2,
                                      beta_hidden=max(16, wcfg.hidden_size // 3), dropout=0.1)
    fusion.init_weights(torch.Generator().manual_seed(0))
    if fusion_ckpt:
        ckpt = load_torch_checkpoint(fusion_ckpt)
        ck = ckpt.get("args", {})
        fusion = FusionWithEmotionDecoder(
            d_model=ck.get("d_model", wcfg.hidden_size),
            num_emotions=len(ckpt.get("emo_cols", [])) or num_emotions,
            n_heads=ck.get("n_heads", 8), num_layers_fusion=ck.get("num_layers_fusion", 2),
            num_layers_decoder=ck.get("num_layers_decoder", 2),
            beta_hidden=ck.get("beta_hidden", 256), dropout=ck.get("dropout", 0.1))
        fusion.load_state_dict(ckpt["model_state_dict"], strict=True)
        note = f"fusion: {fusion_ckpt}"
    wav, wmask = _probe_inputs("wavlm")
    ids, tmask = _probe_inputs("bert")
    args = tuple(torch.from_numpy(a).to(device)
                 for a in (wav, wmask, ids % bcfg.vocab_size, tmask))
    stack = serving_stack(wavlm, bert, fusion).to(device).eval()
    report = int8_numerics_report(stack_apply(multi_label), stack, args, envelope=envelope)
    report["fusion_source"] = note
    return report


def _check_against_golden(golden_path: str, results: dict, atol: float) -> None:
    with open(golden_path) as f:
        golden = json.load(f)
    for name, rep in results.items():
        if name not in golden.get("results", {}):
            continue
        want, got = golden["results"][name]["fingerprint"], rep["fingerprint"]
        if want["shape"] != got["shape"]:
            raise AssertionError(f"{name}: golden shape {want['shape']} != {got['shape']}")
        for field in ("mean", "std", "absmax"):
            if abs(want[field] - got[field]) > max(atol, 1e-3 * abs(want[field])):
                raise AssertionError(f"{name}: golden {field} {want[field]:.6g} != "
                                     f"{got[field]:.6g}")
        d = np.abs(np.asarray(want["first8"]) - np.asarray(got["first8"])).max()
        if d > 10 * atol:
            raise AssertionError(f"{name}: golden first8 max|d|={d:.2e}")
    print(f"golden check OK vs {golden_path}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--wavlm", help="path to a WavLM HF state dict (.bin/.pt/.safetensors)")
    ap.add_argument("--bert", help="path to a BERT HF state dict")
    ap.add_argument("--wavlm-config", default=None,
                    help="JSON dict of WavLMConfig overrides (default: base-plus)")
    ap.add_argument("--bert-config", default=None,
                    help="JSON dict of BertConfig overrides (default: base-uncased)")
    ap.add_argument("--atol", type=float, default=ATOL_DEFAULT)
    ap.add_argument("--out", default=None, help="write the golden JSON here")
    ap.add_argument("--check-golden", default=None,
                    help="compare fingerprints against an existing golden file")
    ap.add_argument("--no-hf-compare", action="store_true",
                    help="skip the comparison with HF's forward")
    ap.add_argument("--int8-report", default=None, metavar="OUT_JSON",
                    help="run the int8 W8A8 numerics report on the weights and write it "
                         "here; needs --wavlm and --bert")
    ap.add_argument("--int8-envelope", type=float, default=0.005,
                    help="max allowed |d prob| of the int8 serving path")
    ap.add_argument("--fusion-ckpt", default=None,
                    help="reference-layout best_*.pt for the fusion stack of the int8 report "
                         "(else random)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if not args.wavlm and not args.bert:
        ap.error("provide --wavlm and/or --bert")
    if args.int8_report and not (args.wavlm and args.bert):
        ap.error("--int8-report needs both --wavlm and --bert")
    from ..device import resolve_device

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 parity needs full fp32 products
    torch.backends.cudnn.allow_tf32 = False
    w_over = json.loads(args.wavlm_config) if args.wavlm_config else {}
    b_over = json.loads(args.bert_config) if args.bert_config else {}

    results = {}
    for name, path, fn, over in (("wavlm", args.wavlm, validate_wavlm, w_over),
                                 ("bert", args.bert, validate_bert, b_over)):
        if not path:
            continue
        results[name] = rep = fn(_load_state_dict(path), over, args.atol,
                                 not args.no_hf_compare, device)
        hf = (f", max|d| vs HF = {rep['hf_max_delta_valid']:.2e}"
              if "hf_max_delta_valid" in rep else f" ({rep.get('hf_compare', 'no HF compare')})")
        print(f"{name}: bridge OK{hf}")

    if args.int8_report:
        rep = int8_report(_load_state_dict(args.wavlm), _load_state_dict(args.bert),
                          args.fusion_ckpt, args.int8_envelope, w_over, b_over, device)
        with open(args.int8_report, "w") as f:
            json.dump(rep, f, indent=2)
        d0, d1 = rep["deltas_full_int8"]["probs"], rep["deltas_final"]["probs"]
        print(f"int8 report: full-int8 |d prob|={d0:.5f}; {len(rep['reverted_layers'])} "
              f"layer(s) reverted -> |d prob|={d1:.5f} "
              f"({'WITHIN' if rep['within_envelope'] else 'EXCEEDS'} envelope "
              f"{args.int8_envelope}); written to {args.int8_report}")
        if not rep["within_envelope"]:
            raise AssertionError("int8 numerics exceed the envelope even after mitigation: "
                                 "do not ship int8 serving with these weights; see the "
                                 "report's activation_amax for the offending layers")
    if args.check_golden:
        _check_against_golden(args.check_golden, results, args.atol)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"probe": "deterministic seed-0 inputs (see _probe_inputs)",
                       "atol": args.atol, "results": results}, f, indent=2)
        print(f"golden written to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
