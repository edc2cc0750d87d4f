#!/usr/bin/env python3
"""Per-component speed-of-light budget of the served forward on the card
(port of ``tools/perf_budget.py``).

At every audio bucket of ``hriemo_torch.bench``, at its text bucket and its
batch from ``MEASURED_BUCKET_BATCH``, each serving component of the W8A8
tree runs alone as a CUDA graph and is timed as the bench times a bucket
(median of five samples of ten replays between CUDA events): the conv
stack, the feature projection with the positional conv, WavLM's 12
attention sublayers (the int8 sublayer kernel), its 12 FFN blocks, BERT,
the fusion stack (cross-modal layers, beta gate, decoder), and the whole
forward. Each is set against its bound: its
products (:mod:`hriemo_torch.utils.flops`) at the H100 SXM dense peaks
(1979 int8 TOP/s, 989 bf16 TFLOP/s, 67 fp32 TFLOP/s). The bound counts
operations only, no bytes, so ``of_bound`` is the share of the compute
bound a component reaches. What the whole forward runs beyond the
components (the transport's conversion, the masks, the position-bias
table, BERT's embeddings) is its time less their sum.

    python3 -m hriemo_torch.tools.perf_budget [--buckets 2.5 10]

Writes ``chip_smoke_out/perf_budget_h100.json``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np
import torch

from .. import bench
from ..device import resolve_device
from ..frontends.wavlm import feat_extract_output_lengths, relative_position_buckets
from ..infer.streaming import MEASURED_BUCKET_BATCH, capture_graph
from ..ops.attention_block import attention_block_int8
from ..ops.fused_ffn import route_ffn_block
from ..utils.flops import PEAK_OPS, served_products

# the products of each component, by name prefix (utils/flops.py)
COMPONENTS = {
    "conv stack": ("wavlm.conv",),
    "feature projection and positional conv": ("wavlm.feature_projection", "wavlm.pos_conv"),
    "WavLM attention sublayers x12": ("wavlm.attn.",),
    "WavLM FFN blocks x12": ("wavlm.ffn",),
    "BERT": ("bert.",),
    "fusion stack": ("fusion.", "beta.", "decoder."),
    "whole forward": ("",),
}


def bound_ms(products, prefixes) -> float:
    return sum(ops / PEAK_OPS[dt] for name, (ops, dt) in products.items.items()
               if name.startswith(prefixes)) * 1e3


def time_graph(fn, args, dev) -> dict:
    """``fn(*args)`` captured alone as a CUDA graph, its replays timed."""
    with torch.inference_mode():
        graph, _ = capture_graph(fn, [a.clone() for a in args], torch.cuda.graph_pool_handle())
        st = bench.sample_times(graph.replay, dev)
    del graph
    torch.cuda.empty_cache()
    return st


def component_inputs(pipe, batch, sec, lt, rng):
    """Each component's inputs at one bucket."""
    dev, dt = pipe.device, pipe._dt
    w = pipe.wavlm
    cfg = w.config
    wavs, lengths, ids, tmask = bench.bucket_inputs(pipe, batch, sec, lt, rng)
    la = int(feat_extract_output_lengths(cfg, int(sec * bench.SR)))
    rand = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32) * 0.3).to(dev, dt)
    h_a, h_t = rand(batch, la, cfg.hidden_size), rand(batch, lt, cfg.hidden_size)
    pos = w.encoder.layers[0].attention.rel_attn_embed.weight[
        relative_position_buckets(cfg, la, dev)].permute(2, 0, 1).contiguous()
    kbias = torch.zeros((batch, la), device=dev)
    no_pad_a = torch.zeros((batch, la), dtype=torch.bool, device=dev)
    no_pad_t = torch.zeros((batch, lt), dtype=torch.bool, device=dev)
    feats = rand(batch, la, cfg.conv_dim[-1])
    return dict(wave=(wavs.to(dt) * (1.0 / 32768.0),), feats=(feats,), attn=(h_a, pos, kbias),
                ffn=(h_a,),
                bert=(ids, tmask), fusion=(h_a, h_t, no_pad_a, no_pad_t),
                forward=(wavs, lengths, ids, tmask))


def budget_bucket(pipe, sec: float, batch: int, rng) -> dict:
    lt = bench.BUCKET_LT[sec]
    w = pipe.wavlm
    eps = w.config.layer_norm_eps
    x = component_inputs(pipe, batch, sec, lt, rng)

    def attn(h, pos, kbias):
        for layer in w.encoder.layers:
            h = attention_block_int8(h, layer.attn_ops, pos, kbias, eps)
        return h

    def ffn(h):
        for layer in w.encoder.layers:
            ff = layer.feed_forward
            h = route_ffn_block(ff["intermediate_dense"], ff["output_dense"],
                                layer.final_layer_norm, h, eps, layer.fast_gelu, layer.ffn_ops)
        return h

    runs = {"conv stack": (w._feature_encoder, x["wave"]),
            "feature projection and positional conv": (w._embed, x["feats"]),
            "WavLM attention sublayers x12": (attn, x["attn"]),
            "WavLM FFN blocks x12": (ffn, x["ffn"]),
            "BERT": (lambda i, m: pipe.bert(i, m)[0], x["bert"]),
            "fusion stack": (lambda *a: pipe.fusion(*a)[0], x["fusion"]),
            "whole forward": (pipe._eager, x["forward"])}
    products = served_products(w.config, pipe.bert.config, bench.fusion_config(pipe.fusion),
                               batch, int(sec * bench.SR), lt)
    rows = {}
    for name, (fn, args) in runs.items():
        st = time_graph(fn, args, pipe.device)
        b = bound_ms(products, COMPONENTS[name])
        rows[name] = dict(ms=st["median_s"] * 1e3, best_ms=st["best_s"] * 1e3,
                          spread=st["spread"], bound_ms=b, of_bound=b / (st["median_s"] * 1e3))
        print(f"  {sec} s B={batch} {name:40s} {rows[name]['ms']:9.3f} ms  bound "
              f"{b:8.3f} ms  ({rows[name]['of_bound']:.1%})", flush=True)
    parts = [r["ms"] for n, r in rows.items() if n != "whole forward"]
    return dict(batch=batch, lt=lt, components=rows, sum_components_ms=sum(parts))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--buckets", type=float, nargs="+", default=list(bench.BUCKETS_S))
    ap.add_argument("--batch", type=int, default=None,
                    help="this batch at every bucket instead of MEASURED_BUCKET_BATCH")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default="chip_smoke_out/perf_budget_h100.json")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    from ..ops import _cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _cuda.build_all()
    card = bench.card()
    print(card, flush=True)
    pipe = bench.serving_pipeline(bench.build_serving_models(args.seed), dev)
    rng = np.random.default_rng(args.seed)
    out = dict(card=card, seed=args.seed, peaks=PEAK_OPS,
               note=("each component alone as a CUDA graph, median of 5 samples of 10 "
                     "replays; bound_ms: its products at the peaks, operations only"),
               buckets={str(sec): budget_bucket(pipe, sec, args.batch or MEASURED_BUCKET_BATCH[sec],
                                                rng)
                        for sec in args.buckets})
    path = pathlib.Path(args.json)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(f"written to {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
