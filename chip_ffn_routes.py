#!/usr/bin/env python3
"""Where each route of the W8A8 FFN pair wins, by rows; and the TMA route's checks.

    python3 chip_ffn_routes.py [--repeats N] [--split]
    python3 chip_ffn_routes.py --check

Run from the repository root on a machine with one NVIDIA GPU and ``nvcc``;
it takes its timing from ``chip_smoke.py``. For each pair of widths a model
of the repo reaches (WavLM's and BERT's FFN, 768 -> 3072 -> 768, tanh and
erf GELU; the fusion FFNs at d=768 and d=256 and the beta gates at both,
ReLU) it runs ``ffn_block_int8`` / ``mlp2_int8`` on every route the widths
take (``route="tma"``, csrc/ffn_tma.cu; ``"chain"``) over a ladder of
rows, bf16 x (and fp32 x for WavLM's FFN at three): the TMA route's hidden
activation (``hq``, ``hs``) bit-equal to the chain's and its output
bit-equal to the chain (mlp2) or within ``chip_smoke.TOL`` of the plain
version (the FFN, whose LayerNorm sums in another order); then CUDA-event
ms of a CUDA graph of 20 calls, the median of N replays. Prints the card's
name and power limit, a line a shape with each route's time, the TMA
route's waves (64-row tiles over the clusters the card runs at once), the
route that ``_cuda.ffn_route`` picks and whether it was the fastest, and a
JSON line of every reading. ``--split`` also times each launch of the TMA
route alone (x's row quantize, ``hr_rowquant`` beside it, the first
product, the second, and mlp2's second on 128-column blocks where the
route takes 192).

``--check`` prints the registers and spills that ptxas reports for every
instance of csrc/ffn_tma.cu, then holds the TMA route at its edges (rows 1,
63, 64, 65, 129, 3072 and 3992 beside the served counts, fp32 x, the erf GELU,
config 1's widths 256 -> 1024 -> 256 and 512 -> 2048 -> 512) to the chain
and the plain version as above (x's quantize bit-equal to ``hr_rowquant``),
each product launched 3 times into outputs filled with a value no correct
output holds (-128 codes, NaN scales and outputs): a tile left unstored
fails. Exits 1 on any failure.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys

import torch

import chip_smoke as C
from hriemo_torch.nn.layers import MLP2, init_torch_defaults
from hriemo_torch.ops import _cuda
from hriemo_torch.ops import fused_ffn as FF

LADDER = (256, 1024, 1996, 3072, 4096, 6144, 8192, 12288, 15968, 23808)
SMALL = (4, 32, 128, 384, 1024, 4096)
# (kernel, d_in, F, d_out, activation, rows, x dtypes)
SHAPES = (
    ("ffn_block_int8", 768, 3072, 768, "tanh", LADDER, (torch.bfloat16,)),
    ("ffn_block_int8", 768, 3072, 768, "tanh", (1996, 8192, 23808), (torch.float32,)),
    ("ffn_block_int8", 768, 3072, 768, "erf", (1996, 4096, 8192, 23808), (torch.bfloat16,)),
    ("ffn_block_int8", 256, 1024, 256, "tanh", (256, 1024, 3072, 8192, 23808),
     (torch.bfloat16,)),
    ("mlp2_int8", 768, 3072, 768, "relu", LADDER, (torch.bfloat16,)),
    ("mlp2_int8", 256, 1024, 256, "relu", (256, 1024, 3072, 8192, 23808), (torch.bfloat16,)),
    ("mlp2_int8", 3072, 256, 768, "relu", SMALL, (torch.bfloat16,)),
    ("mlp2_int8", 1024, 256, 256, "relu", SMALL, (torch.bfloat16,)),
)
EDGE_ROWS = (1, 63, 64, 65, 129, 3072, 3992, 15968, 23808)
CHECK_SHAPES = (
    ("ffn_block_int8", 768, 3072, 768, "tanh", EDGE_ROWS, (torch.bfloat16, torch.float32)),
    ("ffn_block_int8", 768, 3072, 768, "erf", (1, 65, 3992), (torch.bfloat16, torch.float32)),
    ("mlp2_int8", 768, 3072, 768, "relu", EDGE_ROWS, (torch.bfloat16, torch.float32)),
    ("ffn_block_int8", 256, 1024, 256, "tanh", (1, 65, 3992), (torch.bfloat16, torch.float32)),
    ("mlp2_int8", 256, 1024, 256, "relu", (1, 65, 3992), (torch.bfloat16,)),
    ("ffn_block_int8", 512, 2048, 512, "erf", (65, 3992), (torch.bfloat16,)),
)
EPI = {"tanh": _cuda.EPI_GELU_F32, "erf": _cuda.EPI_GELU_ERF_F32, "relu": _cuda.EPI_RELU_F32}
STORE_CHECKS = 3


def pair(kernel, din, f, dout, act, gen):
    """``(ops, call)``: quantized operands of the widths and ``call(x,
    route)`` through the wrapper."""
    mod = MLP2(din, f, dout)
    init_torch_defaults(mod, gen)
    p = C.quantized(mod).ops
    if kernel == "ffn_block_int8":
        ops = FF.FfnOperands(p, torch.rand(dout, generator=gen).add(0.5).cuda(),
                             (0.1 * torch.randn(dout, generator=gen)).cuda())
        return ops, lambda x, route: FF.ffn_block_int8(x, ops, 1e-5, act == "tanh", route=route)
    return p, lambda x, route: FF.mlp2_int8(x, p, route=route)


def plain(kernel, ops, act, x):
    if kernel == "ffn_block_int8":
        return FF.ffn_block_int8_plain(x, ops, 1e-5, act == "tanh")
    return FF.mlp2_int8_plain(x, ops)


def tma_stores(kernel, ops, act, x):
    """The TMA route's three launches into outputs filled with what no
    correct output holds; returns ``(hq, hs, out)``."""
    p = ops.pair if kernel == "ffn_block_int8" else ops
    m = x.shape[0]
    (f, k), n = p.w1.shape, p.w2.shape[0]
    xq, xs = _cuda.ffn_tma_xquant(x)
    rq, rs = _cuda.rowquant(x, div127=False)
    if not (torch.equal(xq, rq) and torch.equal(xs, rs)):
        raise AssertionError("the TMA route's x quantize differs from hr_rowquant's")
    hq = torch.full((m, f), -128, dtype=torch.int8, device="cuda")
    hs = torch.full((m,), float("nan"), device="cuda")
    out = torch.full((m, n), float("nan"), dtype=x.dtype, device="cuda")
    _cuda.ffn_tma_gemm1(xq, xs, p.w1, p.s1, p.b1, EPI[act], out=(hq, hs))
    norm = (ops.ln_w, ops.ln_b, 1e-5) if kernel == "ffn_block_int8" else None
    _cuda.ffn_tma_gemm2(hq, hs, p.w2, p.s2, p.b2, x.dtype, resid=x if norm else None,
                        norm=norm, out=out)
    return hq, hs, out


def check_tma(kernel, ops, act, x, call, name):
    """The TMA route against the chain and plain; raises on a difference.
    Returns the output's max |error| against plain."""
    p = ops.pair if kernel == "ffn_block_int8" else ops
    xq, xs = _cuda.rowquant(x, div127=False)
    hq_ref, hs_ref = _cuda.rowquant(_cuda.int8_gemm(xq, xs, p.w1, p.s1, p.b1, EPI[act]),
                                    div127=False)
    chain = call(x, "chain")
    for i in range(STORE_CHECKS):
        hq, hs, out = tma_stores(kernel, ops, act, x)
        torch.cuda.synchronize()
        if not (torch.equal(hq, hq_ref) and torch.equal(hs, hs_ref)):
            bad = (hq != hq_ref).any(dim=1) | (hs != hs_ref)
            raise AssertionError(f"{name}: TMA hq/hs differ from the chain's in "
                                 f"{int(bad.sum())} rows (first {bad.nonzero()[:4].flatten()}), "
                                 f"launch {i}")
        if not torch.isfinite(out.float()).all():
            raise AssertionError(f"{name}: TMA output left {int((~out.isfinite()).sum())} "
                                 f"elements unstored, launch {i}")
        if kernel == "mlp2_int8" and not torch.equal(out, chain):
            raise AssertionError(f"{name}: TMA output differs from the chain by "
                                 f"{(out.float() - chain.float()).abs().max()}, launch {i}")
    got = call(x, "tma")
    err, _ = C.compare(f"{name} tma", got, plain(kernel, ops, act, x))
    return err


def ptxas_report():
    """Registers and spills of each csrc/ffn_tma.cu instance from the build's
    ptxas log."""
    log = (_cuda._build_dir() / "libffn_tma.log").read_text()
    out, fn, spill = [], None, (None, None)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            demangled = subprocess.run(["c++filt", fn], capture_output=True, text=True).stdout
            out.append(dict(kernel=demangled.strip() or fn, registers=int(m.group(1)),
                            spill_stores=spill[0], spill_loads=spill[1]))
            fn = None
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_ffn_routes: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"build: {_cuda.build_all()}", flush=True)
    gen = torch.Generator().manual_seed(C.SEED + 21)
    sms = _cuda.sm_count()
    if args.check:
        regs = ptxas_report()
        for r in regs:
            print(f"ptxas {r['kernel']}: {r['registers']} registers, spill stores "
                  f"{r['spill_stores']} loads {r['spill_loads']} bytes", flush=True)
        fails = []
        for kernel, din, f, dout, act, rows, dtypes in CHECK_SHAPES:
            ops, call = pair(kernel, din, f, dout, act, gen)
            for dt in dtypes:
                for m in rows:
                    x = torch.randn(m, din, generator=gen).to("cuda", dt)
                    name = f"{kernel} {din}->{f}->{dout} {act} {str(dt)[6:]} M={m}"
                    try:
                        err = check_tma(kernel, ops, act, x, call, name)
                        print(f"{name}: hq/hs bit-equal to the chain"
                              f"{', output bit-equal' if kernel == 'mlp2_int8' else ''}; "
                              f"max |d| against plain {err:.4g}", flush=True)
                    except (AssertionError, RuntimeError) as e:
                        fails.append(str(e))
                        print(f"FAIL {e}", flush=True)
                        if isinstance(e, RuntimeError):
                            raise
        print(json.dumps(dict(card=smi, ptxas=regs, failures=fails)))
        return 1 if fails else 0

    out = dict(card=smi, sms=sms, rows=[])
    for kernel, din, f, dout, act, rows, dtypes in SHAPES:
        ops, call = pair(kernel, din, f, dout, act, gen)
        p = ops.pair if kernel == "ffn_block_int8" else ops
        epi = EPI[act]
        plan = _cuda.ffn_tma_plan(f, din, dout, ln=kernel == "ffn_block_int8")
        routes = (("tma",) if plan else ()) + ("chain",)
        for dt in dtypes:
            for m in rows:
                x = torch.randn(m, din, generator=gen).to("cuda", dt)
                name = f"{kernel} {din}->{f}->{dout} {act} {str(dt)[6:]} M={m}"
                if plan is not None:
                    check_tma(kernel, ops, act, x, call, name)
                ms = {r: C.cuda_ms(lambda r=r: call(x, r), repeats=args.repeats)
                      for r in routes}
                picked = _cuda.ffn_route(f, m, din, epi, sms, n=dout)
                rec = dict(kernel=kernel, widths=[din, f, dout], act=act, dtype=str(dt)[6:],
                           m=m, tma_waves=None, tma_ms=ms.get("tma"), chain_ms=ms["chain"],
                           picked=picked, picked_faster=ms[picked] <= min(ms.values()))
                grid = ""
                if plan is not None:
                    ncl = _cuda.ffn_tma_clusters(1, f, din, epi, plan[0])
                    rec.update(tma_waves=-(-m // 64) / ncl, tma_clusters=ncl)
                    grid += (f"tma {ms['tma']:.4f} ms (waves {rec['tma_waves']:.3f} of "
                             f"{ncl} clusters); ")
                if args.split and plan is not None:
                    xq, xs = _cuda.ffn_tma_xquant(x)
                    hq, hs = _cuda.ffn_tma_gemm1(xq, xs, p.w1, p.s1, p.b1, epi)
                    norm = (ops.ln_w, ops.ln_b, 1e-5) if kernel == "ffn_block_int8" else None
                    rec["tma_split_ms"] = dict(
                        xquant=C.cuda_ms(lambda: _cuda.ffn_tma_xquant(x)),
                        rowquant=C.cuda_ms(lambda: _cuda.rowquant(x, div127=False)),
                        gemm1=C.cuda_ms(lambda: _cuda.ffn_tma_gemm1(xq, xs, p.w1, p.s1, p.b1,
                                                                     epi)),
                        gemm2=C.cuda_ms(lambda: _cuda.ffn_tma_gemm2(
                            hq, hs, p.w2, p.s2, p.b2, x.dtype,
                            resid=x if norm else None, norm=norm)))
                    if dout % 128 == 0 and plan[1] != 128 and (not norm or dout // 128 <= 8):
                        rec["tma_split_ms"]["gemm2 (128 columns)"] = C.cuda_ms(
                            lambda: _cuda.ffn_tma_gemm2(hq, hs, p.w2, p.s2, p.b2, x.dtype,
                                                        resid=x if norm else None, norm=norm,
                                                        bn=128))
                    grid += f"split {rec['tma_split_ms']}; "
                out["rows"].append(rec)
                print(f"{name}: {grid}chain {ms['chain']:.4f} ms; picks {picked}"
                      f"{'' if rec['picked_faster'] else ' (not the fastest)'}", flush=True)
                del x
            torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
