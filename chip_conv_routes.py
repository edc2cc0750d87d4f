#!/usr/bin/env python3
"""The WavLM feature encoder on its two routes, launch by launch, at the
served batches.

    python3 chip_conv_routes.py [--repeats N] [--pairs 1.25:384 10:32 ...]

Run from the repository root on a machine with one NVIDIA GPU and ``nvcc``;
it takes its timing from ``chip_smoke.py`` (CUDA-event ms of a CUDA graph of
several calls, the median of N replays). At each (bucket, batch) of
``MEASURED_BUCKET_BATCH`` and at the thin grids (B = 1, 4 and 8 at 3.75 s
and 10 s), on WavLM base-plus's conv stack in bf16 (random weights from a
seed, tanh GELU as served), it times:

* the kernels: ``conv_stack_stats``, ``conv_stack_k1`` (and its two parts:
  conv0's pass with GroupNorm and GELU, then the three conv GEMMs),
  ``conv_stack_k2``, the whole ``conv_stack_fused`` on prepared operands,
  and ``stack_operands`` alone (the weight copies a forward made before
  they were prepared once);
* the cuDNN route's counterpart of each: the Gram-matrix statistics
  (``group_norm_stats_from_waveform``), cuDNN conv0 with the GroupNorm apply
  and the GELUs of conv0..3, conv4..6 with their GELUs and the final
  transpose, and the whole route (``WavLMEncoder._cudnn_convs``).

Prints the card's name and power limit, a line a pair with both routes'
launches and wholes, the bound of each stage (``chip_smoke.bound``), the
route ``conv_stack.conv_stack_route`` picks and whether it is the faster
(or within ``chip_smoke.ROUTE_NOISE`` and ``ROUTE_NOISE_MS``), the max
|fused - route| of the outputs, and a JSON line of every reading (also
``chip_smoke_out/conv_stack_routes_h100.json``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

import chip_smoke as C
from hriemo_torch.frontends import WavLMConfig, WavLMEncoder
from hriemo_torch.infer.streaming import MEASURED_BUCKET_BATCH
from hriemo_torch.ops import _cuda
from hriemo_torch.ops import conv_stack as CS

SR = 16_000
THIN = ((3.75, 1), (3.75, 4), (3.75, 8), (10.0, 1), (10.0, 4), (10.0, 8))


def stage_bounds(b: int, tw: int, wave, x3, out) -> dict:
    """Each stage's least time (ms, and what bounds it) in bf16: its
    products at the bf16 tensor-core rate (conv0's too), its inputs read and
    outputs written once at the memory rate."""
    lens = CS.conv_lengths(tw)
    c = CS.CHANNELS
    ops0 = 2 * b * lens[0] * c * 10
    ops1 = 2 * b * sum(lens[1:4]) * c * c * 3
    ops2 = 2 * b * (3 * lens[4] + 2 * lens[5] + 2 * lens[6]) * c * c
    w_bytes = 2 * c * c * (3 + 3 + 3) + 2 * c * 10 + 8 * c
    stats_bytes = b * 2 * c * 4
    wave_bytes = C.nbytes(wave)
    return {"stats": C.bound(wave_bytes + 2 * c * 10 + stats_bytes, bf16_ops=ops0),
            "k1": C.bound(wave_bytes + stats_bytes + w_bytes + C.nbytes(x3),
                          bf16_ops=ops0 + ops1),
            "k2": C.bound(C.nbytes(x3) + 2 * c * c * 7 + C.nbytes(out), bf16_ops=ops2),
            "whole": C.bound(wave_bytes + 2 * c * c * 16 + 2 * c * 10 + 8 * c + C.nbytes(out),
                             bf16_ops=2 * ops0 + ops1 + ops2)}


def pair(enc, gen, sec: float, b: int, repeats: int) -> dict:
    tw = int(sec * SR)
    cfg = enc.config
    fe = enc.feature_extractor
    dt = torch.bfloat16
    wave = (torch.randn(b, tw, generator=gen) * 0.1).to("cuda", dt)
    eps = cfg.layer_norm_eps
    # about 150 ms of calls a graph, at least 3
    iters = max(3, min(20, int(2e8 // (b * tw))))
    ms = lambda fn: C.cuda_ms(fn, iters=iters, repeats=repeats)  # noqa: E731

    with torch.no_grad():
        w0, gn_w, gn_b, *taps = CS.prepared_operands(fe, dt)
        stats = CS.conv_stack_stats(wave, w0)
        x0 = CS._conv0_launch(wave, stats, w0, gn_w, gn_b, eps, True)
        x3 = CS.conv_stack_k1(wave, stats, w0, gn_w, gn_b, *taps[:3], eps, True)
        out = CS.conv_stack_k2(x3, *taps[3:], True)
        conv0 = fe.conv_layers[0].conv
        mv = CS.group_norm_stats_from_waveform(wave, conv0.weight)
        x3_cf = enc._cudnn_convs(wave[:, None, :], range(4), stats=mv)
        route_out = enc._cudnn_convs(wave[:, None, :], range(7), wave).transpose(1, 2)
        err = (out.float() - route_out.float()).abs().max().item()
        rec = dict(bucket_s=sec, b=b, tw=tw, iters=iters, max_abs_fused_vs_route=err)
        kern = {
            "stats": lambda: CS.conv_stack_stats(wave, w0),
            "k1": lambda: CS.conv_stack_k1(wave, stats, w0, gn_w, gn_b, *taps[:3], eps, True),
            "k1_conv0_pass": lambda: CS._conv0_launch(wave, stats, w0, gn_w, gn_b, eps, True),
            "k1_conv1_3": lambda: CS._conv_launches(x0, taps[:3], True),
            "k2": lambda: CS.conv_stack_k2(x3, *taps[3:], True),
            "whole": lambda: CS.conv_stack_fused(fe, wave, cfg),
            "stack_operands": lambda: CS.stack_operands(fe, dt)}
        route = {
            "stats": lambda: CS.group_norm_stats_from_waveform(wave, conv0.weight),
            "k1": lambda: enc._cudnn_convs(wave[:, None, :], range(4), stats=mv),
            "k2": lambda: enc._cudnn_convs(x3_cf, range(4, 7)).transpose(1, 2).contiguous(),
            "whole": lambda: enc._cudnn_convs(wave[:, None, :], range(7), wave).transpose(
                1, 2).contiguous()}
        rec["kernels_ms"] = {k: ms(fn) for k, fn in kern.items()}
        rec["route_ms"] = {k: ms(fn) for k, fn in route.items()}
        rec["bound"] = stage_bounds(b, tw, wave, x3, out)
    del x0, x3, out, x3_cf, route_out
    torch.cuda.empty_cache()
    k, r = rec["kernels_ms"], rec["route_ms"]
    rec["kernels_sum_ms"] = k["stats"] + k["k1"] + k["k2"]
    rec["route_sum_ms"] = r["stats"] + r["k1"] + r["k2"]
    picked = CS.conv_stack_route("cuda", dt, b, tw)
    mine, other = ((k["whole"], r["whole"]) if picked == "fused" else (r["whole"], k["whole"]))
    rec["picked"] = picked
    rec["picked_ok"] = mine <= other * (1 + C.ROUTE_NOISE) + C.ROUTE_NOISE_MS
    print(f"{sec:6g} s B={b:3d}: kernels stats {k['stats']:.4f} K1 {k['k1']:.4f} (conv0 pass "
          f"{k['k1_conv0_pass']:.4f}, conv1-3 {k['k1_conv1_3']:.4f}) K2 {k['k2']:.4f} sum "
          f"{rec['kernels_sum_ms']:.4f} whole {k['whole']:.4f} ms (stack_operands "
          f"{k['stack_operands']:.4f}); route stats {r['stats']:.4f} K1 {r['k1']:.4f} K2 "
          f"{r['k2']:.4f} sum {rec['route_sum_ms']:.4f} whole {r['whole']:.4f} ms; bound "
          + ", ".join(f"{n} {v[0]:.4f} ({v[1]})" for n, v in rec["bound"].items())
          + f"; picked {picked} ({'ok' if rec['picked_ok'] else 'SLOWER'}); max|fused - "
          f"route| {err:.3g}", flush=True)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--pairs", nargs="*", default=None,
                    help="bucket:batch pairs (default: the served ones and the thin grids)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_conv_routes: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _cuda.build_all()
    pairs = ([(float(p.split(":")[0]), int(p.split(":")[1])) for p in args.pairs] if args.pairs
             else [*MEASURED_BUCKET_BATCH.items(), *THIN])
    gen = torch.Generator().manual_seed(C.SEED)
    enc = WavLMEncoder(WavLMConfig(num_hidden_layers=1, fast_gelu=True))
    enc.init_weights(gen)
    enc = enc.to("cuda", torch.bfloat16).eval()
    recs = [pair(enc, gen, sec, b, args.repeats) for sec, b in pairs]
    served = [r for r in recs if MEASURED_BUCKET_BATCH.get(r["bucket_s"]) == r["b"]]
    summary = dict(card=smi, pairs=recs,
                   served_kernels_whole_ms=sum(r["kernels_ms"]["whole"] for r in served),
                   served_route_whole_ms=sum(r["route_ms"]["whole"] for r in served),
                   all_picked_ok=all(r["picked_ok"] for r in recs))
    C.OUT.mkdir(exist_ok=True)
    (C.OUT / "conv_stack_routes_h100.json").write_text(json.dumps(summary, indent=1))
    print(f"served pairs summed: kernels {summary['served_kernels_whole_ms']:.3f} ms, route "
          f"{summary['served_route_whole_ms']:.3f} ms; every pick the faster or within noise: "
          f"{summary['all_picked_ok']}", flush=True)
    print(json.dumps(summary))
    return 0 if summary["all_picked_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
