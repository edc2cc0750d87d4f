#!/usr/bin/env python3
"""Per-bucket numerics of the port's serving kernels on the card (port of
``tools/kernel_numerics.py``).

Each serving kernel runs against its plain PyTorch version on the same
inputs and the same int8 operands, at the serving shapes: the int8 WavLM
attention sublayer at every audio bucket, the int8 MHA sublayer at BERT's
and the fusion stack's self- and cross-attention shapes for every text
bucket, the int8 FFN block at the smallest and the largest bucket's rows,
``mlp2_int8`` at the beta gate's rectangle, the flash cores and the
GroupNorm statistics. Batch 8, full width, random weights from ``--seed``.
The rows are the ``(kernel, shape)`` set of the JAX package's
``kernel_numerics.json`` and, of the port's own, the conv stack (stats, K1
and K2 as the served bf16 encoder runs them) at every audio bucket, its
clips zero-padded past their lengths as a bucket pads them, and WavLM's
gated int8 core on its wgmma warpgroups (``csrc/onepass_wgmma.cuh``,
``kernel="wgmma"``) at every audio bucket; the buckets
are the port's own
(``infer/e2e_infer.py``'s ``--bucket_seconds`` and ``--text_bucket_tokens``),
and the pass limits the JAX tool's.

    python -m hriemo_torch.tools.kernel_numerics --json hriemo_torch/kernel_numerics_h100.json

On the CPU (``--device cpu``) every wrapper takes its plain version, so
each delta is 0: a check of the tool, not of a kernel.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

B = 8  # batch of every comparison
THRESH = {  # the JAX tool's pass limits (tools/kernel_numerics.py:55-62)
    "wavlm_attention_block": 0.05,
    "mha_block": 0.05,
    "ffn_block": 0.05,
    "mlp2": 0.05,
    "flash_mha": 0.02,
    "groupnorm_stats": 1e-3,
    # the port's own rows: the served feature encoder's conv stack (bf16
    # outputs of O(1)) and the WavLM core on its wgmma warpgroups (bf16 ctx of
    # O(1)), at the sublayers' limit
    "conv_stack": 0.05,
    "int8_core_wgmma": 0.05,
}


def serving_buckets() -> tuple[tuple, tuple]:
    """The port's audio buckets (seconds) and text buckets (tokens): the
    defaults of ``e2e_infer``'s ``--bucket_seconds`` and
    ``--text_bucket_tokens``."""
    from ..infer.e2e_infer import parse_args

    args = parse_args(["--index_csv", "unused.csv"])
    return tuple(args.bucket_seconds), tuple(args.text_bucket_tokens)


def bucket_frames(buckets) -> dict:
    """``{bucket seconds: WavLM frames}`` at base-plus's conv stack."""
    from ..frontends.wavlm import WavLMConfig, feat_extract_output_lengths

    cfg = WavLMConfig.base_plus()
    return {sec: int(feat_extract_output_lengths(cfg, int(sec * 16_000))) for sec in buckets}


def expected_rows() -> list[tuple[str, str]]:
    """Every ``(kernel, shape)`` the tool records, from the port's buckets."""
    audio, text = serving_buckets()
    frames = bucket_frames(audio)
    la = max(frames.values())
    rows = [("wavlm_attention_block", f"L={l} (bucket {sec}s)") for sec, l in frames.items()]
    rows += [("mha_block", f"self L={la}"), ("mha_block", f"cross {la}x128"),
             ("mha_block", "self L=128")]
    for lt in text:
        rows += [("mha_block", f"self L={lt}"), ("mha_block", f"cross {la}x{lt}"),
                 ("mha_block", f"cross {lt}x{la}")]
    rows += [("ffn_block", f"M={B * min(frames.values())}"),
             ("ffn_block", f"M={B * la}"), ("mlp2", "3072->256->768"),
             ("flash_mha", f"Lq={la} Lk={la}"), ("flash_mha", f"Lq={la} Lk=128"),
             ("groupnorm_stats", "mean"), ("groupnorm_stats", "var")]
    return rows


def port_rows() -> list[tuple[str, str]]:
    """The rows beyond the JAX tool's: the served conv stack and the gated
    int8 core on its wgmma warpgroups (csrc/onepass_wgmma.cuh) at every
    audio bucket."""
    audio, _ = serving_buckets()
    frames = bucket_frames(audio)
    return [("conv_stack", f"Tw={int(sec * 16_000)} (bucket {sec}s)") for sec in audio] + \
        [("int8_core_wgmma", f"L={frames[sec]} (bucket {sec}s)") for sec in audio]


def _delta(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


class Checks:
    """The comparisons, on ``device`` with inputs from ``seed``; ``b`` and
    ``frames`` may be cut for a quick run on the CPU."""

    def __init__(self, device, seed: int, b: int = B, frames: dict | None = None,
                 text: tuple | None = None):
        self.dev = torch.device(device)
        self.gen = torch.Generator().manual_seed(seed)
        self.b = b
        audio, text_buckets = serving_buckets()
        self.frames = frames or bucket_frames(audio)
        self.text = text_buckets if text is None else text
        self.results = []

    def randn(self, *shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=self.gen) * scale).to(self.dev, dtype)

    def lengths_mask(self, l: int):
        """``[b, l]`` bool, True = PAD, each row valid up to a length in
        [l/2, l]."""
        lens = torch.randint(l // 2, l + 1, (self.b,), generator=self.gen)
        return (torch.arange(l)[None, :] >= lens[:, None]).to(self.dev)

    def record(self, kernel: str, shape: str, got, ref):
        self.results.append((kernel, shape, _delta(got, ref)))

    @torch.no_grad()
    def wavlm_attention_block(self):
        from ..frontends.wavlm import WavLMConfig, WavLMEncoder, relative_position_buckets
        from ..ops import attention_block as AB
        from ..ops.quant import quantize_for_serving

        cfg = WavLMConfig(num_hidden_layers=1, fast_gelu=True)
        enc = WavLMEncoder(cfg)
        enc.init_weights(self.gen)
        layer = quantize_for_serving(enc.to(self.dev, torch.bfloat16).eval()).encoder.layers[0]
        table = layer.attention.rel_attn_embed.weight
        for sec, l in self.frames.items():
            x = self.randn(self.b, l, cfg.hidden_size, scale=0.3)
            pos = table[relative_position_buckets(cfg, l, self.dev)].permute(2, 0, 1).contiguous()
            kb = torch.where(self.lengths_mask(l), AB.NEG_INF, 0.0).float()
            self.record("wavlm_attention_block", f"L={l} (bucket {sec}s)",
                        AB.attention_block_int8(x, layer.attn_ops, pos, kb, cfg.layer_norm_eps),
                        AB.attention_block_int8_plain(x, layer.attn_ops, pos, kb,
                                                      cfg.layer_norm_eps))

    @torch.no_grad()
    def mha_block(self):
        from ..nn.attention import MultiheadAttention
        from ..nn.layers import init_torch_defaults
        from ..ops import attention_block as AB
        from ..ops.quant import quantize_for_serving

        d, h = 768, 8
        mha = MultiheadAttention(d, h)
        init_torch_defaults(mha, self.gen)
        ops = quantize_for_serving(mha.to(self.dev, torch.bfloat16).eval()).ops
        la = max(self.frames.values())
        shapes = [(la, la, f"self L={la}"), (la, 128, f"cross {la}x128"),
                  (128, 128, "self L=128")]
        for lt in self.text:
            shapes += [(lt, lt, f"self L={lt}"), (la, lt, f"cross {la}x{lt}"),
                       (lt, la, f"cross {lt}x{la}")]
        for lq, lk, tag in shapes:
            xq = self.randn(self.b, lq, d, scale=0.5)
            xkv = xq if tag.startswith("self") else self.randn(self.b, lk, d, scale=0.5)
            kpm = self.lengths_mask(lk)
            self.record("mha_block", tag, AB.mha_block_int8(xq, xkv, ops, kpm),
                        AB.mha_block_int8_plain(xq, xkv, ops, kpm))

    @torch.no_grad()
    def ffn_block(self):
        from ..ops import fused_ffn as FF
        from ..ops.quant import quantize_linear_params

        d, f = 768, 3072
        w1, w2 = self.randn(f, d, scale=0.03, dtype=torch.float32), \
            self.randn(d, f, scale=0.03, dtype=torch.float32)
        b1, b2 = self.randn(f, scale=0.02, dtype=torch.float32), \
            self.randn(d, scale=0.02, dtype=torch.float32)
        (q1, s1), (q2, s2) = quantize_linear_params(w1), quantize_linear_params(w2)
        ln_w = torch.full((d,), 0.9, device=self.dev)
        ln_b = torch.full((d,), 0.05, device=self.dev)
        ops = FF.FfnOperands(FF.Mlp2Operands(q1, s1, b1, q2, s2, b2), ln_w, ln_b)
        for l in (min(self.frames.values()), max(self.frames.values())):
            x = self.randn(self.b * l, d, scale=0.5)
            self.record("ffn_block", f"M={self.b * l}", FF.ffn_block_int8(x, ops, 1e-5, True),
                        FF.ffn_block_int8_plain(x, ops, 1e-5, True))

    @torch.no_grad()
    def mlp2(self):
        from ..ops import fused_ffn as FF
        from ..ops.quant import quantize_linear_params

        din, f, dout = 3072, 256, 768  # the beta gate's rectangle
        (q1, s1) = quantize_linear_params(self.randn(f, din, scale=0.02, dtype=torch.float32))
        (q2, s2) = quantize_linear_params(self.randn(dout, f, scale=0.05, dtype=torch.float32))
        ops = FF.Mlp2Operands(q1, s1, torch.zeros(f, device=self.dev), q2, s2,
                              torch.zeros(dout, device=self.dev))
        x = self.randn(64, din, scale=0.5)
        self.record("mlp2", f"{din}->{f}->{dout}", FF.mlp2_int8(x, ops),
                    FF.mlp2_int8_plain(x, ops))

    @torch.no_grad()
    def flash_mha(self):
        from ..ops import flash_attention as FA

        h, hd = 8, 96
        la = max(self.frames.values())
        for lq, lk in ((la, la), (la, 128)):
            q, k, v = (self.randn(self.b, h, n, hd, scale=0.3) for n in (lq, lk, lk))
            kpm = self.lengths_mask(lk)
            self.record("flash_mha", f"Lq={lq} Lk={lk}", FA.flash_mha(q, k, v, kpm),
                        FA.flash_mha_plain(q, k, v, kpm))

    @torch.no_grad()
    def groupnorm_stats(self):
        from ..ops import conv_stack as CS

        wave = self.randn(self.b, 80000, scale=0.1, dtype=torch.float32)
        w0 = self.randn(512, 10, scale=0.2, dtype=torch.float32)
        n = CS.conv_lengths(wave.shape[1])[0]

        def mean_var(sums):
            mean = sums[:, 0] / n
            return mean, torch.clamp_min(sums[:, 1] / n - mean * mean, 0.0)

        (km, kv), (rm, rv) = (mean_var(CS.conv_stack_stats(wave, w0)),
                              mean_var(CS.conv_stack_stats_plain(wave, w0)))
        self.record("groupnorm_stats", "mean", km, rm)
        self.record("groupnorm_stats", "var", kv, rv)

    @torch.no_grad()
    def conv_stack(self):
        from ..frontends.wavlm import WavLMConfig, WavLMEncoder
        from ..ops import conv_stack as CS

        cfg = WavLMConfig(num_hidden_layers=1, fast_gelu=True)
        enc = WavLMEncoder(cfg)
        enc.init_weights(self.gen)
        fe = enc.to(self.dev, torch.bfloat16).eval().feature_extractor
        for sec in self.frames:
            tw = int(sec * 16_000)
            lens = torch.randint(tw // 2, tw + 1, (self.b,), generator=self.gen)
            keep = (torch.arange(tw)[None, :] < lens[:, None]).to(self.dev, torch.bfloat16)
            wave = self.randn(self.b, tw, scale=0.1) * keep
            self.record("conv_stack", f"Tw={tw} (bucket {sec}s)",
                        CS.conv_stack_fused(fe, wave, cfg),
                        CS.conv_stack_fused(fe, wave, cfg, use_kernels=False))

    @torch.no_grad()
    def int8_core_wgmma(self):
        """WavLM's gated core alone (12 x 64, the gate of a base-plus layer,
        pos from its table) on the wgmma warpgroups, whichever kernel the
        served rule picks at the bucket."""
        from ..frontends.wavlm import WavLMConfig, WavLMEncoder, relative_position_buckets
        from ..ops import attention_block as AB
        from ..ops.quant import quantize_for_serving

        cfg = WavLMConfig(num_hidden_layers=1, fast_gelu=True)
        enc = WavLMEncoder(cfg)
        enc.init_weights(self.gen)
        layer = quantize_for_serving(enc.to(self.dev, torch.bfloat16).eval()).encoder.layers[0]
        ops, table = layer.attn_ops, layer.attention.rel_attn_embed.weight
        d, h = cfg.hidden_size, ops.mha.n_heads
        for sec, l in self.frames.items():
            qkv = self.randn(self.b * l, 3 * d)
            qkv[:, :d] *= (d // h) ** -0.5
            q, k, v = qkv.split(d, dim=1)
            pos = table[relative_position_buckets(cfg, l, self.dev)].permute(2, 0, 1)
            kw = dict(kbias=torch.where(self.lengths_mask(l), AB.NEG_INF, 0.0).float(),
                      gate=(self.randn(self.b * l, d, scale=0.3), ops.wg, ops.bg, ops.gconst,
                            pos.to(torch.bfloat16).contiguous()))
            self.record("int8_core_wgmma", f"L={l} (bucket {sec}s)",
                        AB.attention_core_int8(q, k, v, self.b, h, kernel="wgmma", **kw),
                        AB.attention_core_int8_plain(q, k, v, self.b, h, **kw))

    def run_all(self, log=print) -> list:
        done = 0
        for fn in (self.wavlm_attention_block, self.mha_block, self.ffn_block, self.mlp2,
                   self.flash_mha, self.groupnorm_stats, self.conv_stack, self.int8_core_wgmma):
            fn()
            for name, tag, d in self.results[done:]:
                log(f"{name:24s} {tag:22s} max|d| = {d:.3e}  "
                    f"[{'ok' if d <= THRESH[name] else 'FAIL > ' + str(THRESH[name])}]")
            done = len(self.results)
        return self.results


def card_name() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def report(results, card: str, seed: int) -> dict:
    return {"card": card, "tool": "python -m hriemo_torch.tools.kernel_numerics",
            "batch": B, "seed": seed,
            "rows": [{"kernel": n, "shape": t, "max_delta": d, "threshold": THRESH[n]}
                     for n, t, d in results]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", default=None, help="write the rows here")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    from ..device import resolve_device

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        from ..ops import _cuda

        _cuda.build_all()
    card = card_name() if dev.type == "cuda" else "cpu (plain versions on both sides)"
    print(card, flush=True)
    results = Checks(dev, args.seed).run_all(lambda s: print(s, flush=True))
    fails = sum(d > THRESH[n] for n, _, d in results)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report(results, card, args.seed), f, indent=1)
        print(f"written to {args.json}", flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
