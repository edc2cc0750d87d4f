#!/usr/bin/env python3
"""The WavLM feature encoder on its two routes, launch by launch, at the
served batches.

    python3 chip_conv_routes.py [--repeats N] [--pairs 1.25:384 10:32 ...]
    python3 chip_conv_routes.py --gemms [--pairs ...]
    python3 chip_conv_routes.py --stress N

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

``--gemms`` times instead each stride-2 conv alone, conv1..6, at the same
pairs and at B = 1 at 1 s, on the conv0 pass's output and the kernels'
own chain: the TMA GEMM as the plan picks it (``conv_stack.conv_gemm``) and
with each column tile forced (the readings behind
``_cuda.tma_gemm_plan``), the parent pipeline (``hr_conv_s2`` on
``csrc/float_wgmma.cuh``), the plain version, and as ``library_ms``
``torch.nn.functional.conv1d`` in bf16 on the same conv without its GELU,
in the faster of two layouts (channels first, made outside the call; the
``[B, T, C]`` rows as a channels-last view), which it names; beside each
the bound (products at ``chip_smoke.PEAK_BF16``, the input, taps and output
at the memory rate) and the max |TMA - plain|, which must be within
``chip_smoke.CONV_TOL``. Then K1's three GEMMs and K2's together on both
pipelines. Readings go to ``chip_smoke_out/conv_gemms_h100.json``.

``--stress N`` launches the TMA GEMM N times in a row at each of
``STRESS`` on each column tile, every launch into an output filled with NaN
(random bf16 inputs and taps from a seed, tanh GELU), and counts for each
launch the output tiles (128 rows by the column tile) that hold a NaN,
never stored, and those with a value outside ``chip_smoke.CONV_TOL`` of the
plain version; it exits 1 if any launch has either. Readings go to
``chip_smoke_out/conv_gemm_stress_h100.json``.
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
# (bucket s, batch, conv) of --stress: the first two convs of the largest
# served grid (1.25 s x 384) and of the longest bucket (10 s x 32)
STRESS = ((1.25, 384, 1), (1.25, 384, 2), (10.0, 32, 1), (10.0, 32, 2))


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


def gemm_rows(enc, gen, sec: float, b: int, repeats: int) -> dict:
    """Each of conv1..6 alone at one (bucket, batch): see ``--gemms``."""
    tw = int(sec * SR)
    fe = enc.feature_extractor
    dt = torch.bfloat16
    wave = (torch.randn(b, tw, generator=gen) * 0.1).to("cuda", dt)
    eps = enc.config.layer_norm_eps
    iters = max(3, min(20, int(2e8 // (b * tw))))
    ms = lambda fn, n=iters, r=repeats: C.cuda_ms(fn, iters=n, repeats=r)  # noqa: E731
    rec = dict(bucket_s=sec, b=b, tw=tw, iters=iters, convs=[])
    with torch.no_grad():
        w0, gn_w, gn_b, *taps = CS.prepared_operands(fe, dt)
        x = CS._conv0_launch(wave, CS.conv_stack_stats(wave, w0), w0, gn_w, gn_b, eps, True)
        del wave
        for i, w in enumerate(taps, start=1):
            k = w.shape[0]
            out = CS.conv_gemm(x, w, True)
            ref = CS._conv_s2(x, w, True)
            torch.cuda.synchronize()
            err, med = C.compare(f"conv{i} B={b} Tw={tw}", out, ref, C.CONV_TOL[dt])
            del ref
            m = out.shape[1]
            ops = 2 * b * m * CS.CHANNELS * CS.CHANNELS * k
            bn, grid = _cuda.tma_gemm_plan(b, m, CS.CHANNELS, _cuda.sm_count())
            row = dict(conv=i, m=m, k=k, bn=bn, grid=grid, max_abs_err=err, median_abs_err=med,
                       ms=ms(lambda: CS.conv_gemm(x, w, True)),
                       ms_bn={w_: ms(lambda w_=w_: CS.conv_gemm(x, w, True, bn=w_))
                              for w_ in _cuda.TMA_BN},
                       plain_ms=ms(lambda: CS._conv_s2(x, w, True), max(1, iters // 10), 1),
                       bound=C.bound(C.nbytes(x, w, out), bf16_ops=ops),
                       **C.conv_gemm_yardsticks(x, w, iters=iters, repeats=repeats))
            layout = row["library_layout"]
            rec["convs"].append(row)
            print(f"{sec:6g} s B={b:3d} conv{i} M={m:6d} k={k}: TMA {row['ms']:.4f} ms (BN "
                  f"{bn}, {grid} blocks; " + ", ".join(f"BN {w_} {v:.4f}" for w_, v in
                                                       row["ms_bn"].items())
                  + f") parent {row['parent_ms']:.4f} plain {row['plain_ms']:.4f} library "
                  f"{row['library_ms']:.4f} ({layout}) bound {row['bound'][0]:.4f} "
                  f"({row['bound'][1]}); max|TMA - plain| {err:.3g}", flush=True)
            x = out
        del x
    torch.cuda.empty_cache()
    for name, part in (("k1_gemms", slice(0, 3)), ("k2", slice(3, 6))):
        rows = rec["convs"][part]
        rec[name] = {key: sum(r[key] for r in rows) for key in ("ms", "parent_ms")}
        rec[name]["bound_ms"] = sum(r["bound"][0] for r in rows)
        rec[name]["library_ms"] = sum(r["library_ms"] for r in rows)
    print(f"{sec:6g} s B={b:3d}: K1's GEMMs TMA {rec['k1_gemms']['ms']:.4f} ms, parent "
          f"{rec['k1_gemms']['parent_ms']:.4f}, bound {rec['k1_gemms']['bound_ms']:.4f}; K2 TMA "
          f"{rec['k2']['ms']:.4f}, parent {rec['k2']['parent_ms']:.4f}, bound "
          f"{rec['k2']['bound_ms']:.4f}", flush=True)
    return rec


def tile_faults(got, ref, bn: int) -> tuple[int, int]:
    """Tiles of ``got [B, M, C]`` (``_cuda.TMA_BM`` rows by ``bn`` columns)
    that hold a NaN, and tiles with a finite value outside ``CONV_TOL`` of
    ``ref``."""
    tol = C.CONV_TOL[torch.bfloat16]
    b, m, c = got.shape
    pad = -m % _cuda.TMA_BM
    g = torch.nn.functional.pad(got.float(), (0, 0, 0, pad))
    r = torch.nn.functional.pad(ref.float(), (0, 0, 0, pad))
    nan = g.isnan()
    wrong = ~nan & ((g - r).abs() > tol["atol"] + tol["rtol"] * r.abs())
    tiles = lambda t: t.reshape(b, -1, _cuda.TMA_BM, c // bn, bn).any(dim=(2, 4))  # noqa: E731
    return int(tiles(nan).sum()), int(tiles(wrong).sum())


def stress(gen, launches: int) -> list:
    """See ``--stress``."""
    out = []
    for sec, b, conv in STRESS:
        t_in = CS.conv_lengths(int(sec * SR))[conv - 1]
        k = CS.KERNEL[conv]
        x = torch.randn(b, t_in, CS.CHANNELS, generator=gen).to("cuda", torch.bfloat16)
        w = (torch.randn(k, CS.CHANNELS, CS.CHANNELS, generator=gen)
             * (2.0 / (k * CS.CHANNELS)) ** 0.5).to("cuda", torch.bfloat16)
        ref = CS._conv_s2(x, w, True)
        for bn in _cuda.TMA_BN:
            faults = []
            for i in range(launches):
                got = CS._conv_gemm_into(x, w, True, torch.full_like(ref, float("nan")), bn)
                unstored, wrong = tile_faults(got, ref, bn)
                if unstored or wrong:
                    faults.append(dict(launch=i, unstored_tiles=unstored, wrong_tiles=wrong))
            rec = dict(bucket_s=sec, b=b, conv=conv, m=ref.shape[1], bn=bn, launches=launches,
                       tiles=b * -(-ref.shape[1] // _cuda.TMA_BM) * CS.CHANNELS // bn,
                       faulty_launches=len(faults), faults=faults[:20])
            out.append(rec)
            print(f"{sec:6g} s B={b:3d} conv{conv} M={rec['m']:6d} BN {bn}: {launches} launches "
                  f"of {rec['tiles']} tiles, {len(faults)} with a tile unstored or wrong "
                  f"{faults[:3]}", flush=True)
        del x, w, ref, got
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--pairs", nargs="*", default=None,
                    help="bucket:batch pairs (default: the served ones and the thin grids)")
    ap.add_argument("--gemms", action="store_true", help="each conv's GEMM alone")
    ap.add_argument("--stress", type=int, default=0, metavar="N",
                    help="N launches a shape into NaN-filled outputs")
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
    if args.stress:
        recs = stress(gen, args.stress)
        C.OUT.mkdir(exist_ok=True)
        (C.OUT / "conv_gemm_stress_h100.json").write_text(
            json.dumps(dict(card=smi, shapes=recs), indent=1))
        return 1 if any(r["faulty_launches"] for r in recs) else 0
    enc = WavLMEncoder(WavLMConfig(num_hidden_layers=1, fast_gelu=True))
    enc.init_weights(gen)
    enc = enc.to("cuda", torch.bfloat16).eval()
    if args.gemms:
        if not args.pairs:
            pairs.insert(len(MEASURED_BUCKET_BATCH), (1.0, 1))
        summary = dict(card=smi, pairs=[gemm_rows(enc, gen, sec, b, args.repeats)
                                        for sec, b in pairs])
        C.OUT.mkdir(exist_ok=True)
        (C.OUT / "conv_gemms_h100.json").write_text(json.dumps(summary, indent=1))
        print(json.dumps({k: v for k, v in summary.items() if k != "pairs"}))
        return 0
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
