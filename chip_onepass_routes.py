#!/usr/bin/env python3
"""The float one-pass and streaming attention cores' kernels on the card, shape by shape.

    python3 chip_onepass_routes.py [--streaming] [--check] [--repeats N]

Run from the repository root on a machine with one NVIDIA GPU and ``nvcc``;
it takes its timing from ``chip_smoke.py`` (CUDA-event ms of a CUDA graph of
20 calls, the median of N replays). It prints the card's name and power
limit, then ptxas's registers, spills and stack of every instance of the
wgmma kernels (``csrc/onepass_wgmma.cuh``: the float route's in
``attention_wgmma.cu``, the int8 route's in ``attention.cu``). With
``--check`` it then holds each kernel of ``WA.ONEPASS_KERNELS`` that a shape
admits to the plain version at ``ATTN_TOL`` over the key lengths at the tile
and route edges (bf16 and fp16, gated and not, thin grids and an element
whose keys are all masked), and stops. Without it, it times every kernel
that each shape admits ("mma", the parent's ``mma.sync`` two sweeps;
"wgmma", every score held; "wgmma_sweeps") beside SDPA (a yardstick the port
never calls) at the served shapes of rows 6 and 7 and over a ladder of key
lengths, head dims and batches, and names the kernel
``WA.onepass_kernel`` picks and the fastest. A JSON line of every reading
comes last; the whole lands in ``chip_smoke_out/onepass_routes_h100.json``.

``--streaming`` does the same for the streaming core (row 8,
``FA.STREAMING_KERNELS``: "mma", the parent's ``mma.sync`` kernels;
"wgmma", 128 query rows a block; "wgmma_split", 64 with O split): ptxas's
report of ``csrc/streaming_wgmma.cu``'s instances; with ``--check`` each
wgmma kernel against ``streaming_attention_plain`` at ``ATTN_TOL`` over key
lengths past 2048 and at the step edges, every instance and the zero-filled
head dims, ``Lq`` off 128, an element whose keys are all masked; without,
every kernel that takes each shape beside SDPA at row 8's shapes and over a
ladder of key lengths (2049-4096), head dims and batches (thin and full
grids), with ``FA.streaming_kernel``'s pick and the fastest
(``chip_smoke_out/streaming_routes_h100.json``).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import subprocess
import sys

import torch

import chip_smoke as C
from hriemo_torch.infer.streaming import MEASURED_BUCKET_BATCH
from hriemo_torch.ops import _cuda
from hriemo_torch.ops import attention_block as AB
from hriemo_torch.ops import flash_attention as FA
from hriemo_torch.ops import wavlm_attention as WA
from hriemo_torch.tools.kernel_numerics import bucket_frames

EDGE_KEYS = (1, 63, 65, 128, 129, 192, 193, 256, 257, 511, 512, 513, 1024, 1499, 2047, 2048)
WIDE_EDGE_KEYS = (1, 31, 33, 128, 513, 1024, 1951, 2047, 2048)


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def ptxas() -> list[dict]:
    """ptxas's report of every wgmma kernel instance, from the build logs
    (each function's stack and spill line comes before its register line)."""
    out = []
    for name in ("attention_wgmma", "attention", "streaming_wgmma"):
        log = (_cuda._build_dir() / f"lib{name}.log").read_text()
        fn, spill = None, {}
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                fn, spill = m.group(1), {}
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m:
                spill = dict(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if fn and m and ("wgmma" in fn or "sweeps" in fn or "stats_mma" in fn):
                pretty = subprocess.run(["c++filt", fn], capture_output=True,
                                        text=True).stdout.strip() or fn
                out.append(dict(library=name, kernel=pretty, registers=int(m.group(1)), **spill))
                fn = None
    for r in out:
        print(f"  ptxas {r['library']}: {r['kernel']}: {r['registers']} registers, stack "
              f"{r.get('stack')}, spill stores {r.get('spill_stores')} loads "
              f"{r.get('spill_loads')}", flush=True)
    return out


def inputs(gen, b, lq, lk, h, hd, dt, gated, masked=False):
    """q/k/v head views of [B, L, H*hd] projections, the gate, pos and key
    bias (element 1 with every key masked where ``masked``)."""
    def heads(l):
        return (torch.randn(b, l, h * hd, generator=gen)).to("cuda", dt).view(b, l, h, hd) \
            .transpose(1, 2)
    q, k, v = heads(lq), heads(lk), heads(lk)
    lens = torch.randint(lk // 2, lk + 1, (b,), generator=gen)
    lens[0] = lk
    if masked and b > 1:
        lens[1] = 0
    kb = torch.where(torch.arange(lk)[None, :] >= lens[:, None], AB.NEG_INF, 0.0).float().cuda()
    gate = pos = None
    if gated:
        gate = (torch.rand(b, h, lq, generator=gen) * 1.5 + 0.5).cuda()
        pos = (0.3 * torch.randn(h, lq, lk, generator=gen)).to("cuda", dt)
    return q, k, v, kb, gate, pos


def call(kernel, q, k, v, kb, gate, pos):
    if gate is None:
        return FA.onepass_attention(q, k, v, kb, kernel=kernel)
    return WA.wavlm_fused_attention(q, k, v, gate, pos, kb, kernel=kernel)


def plain(q, k, v, kb, gate, pos):
    if gate is None:
        return FA.onepass_attention_plain(q, k, v, kb)
    return WA.wavlm_fused_attention_plain(q, k, v, gate, pos, kb)


def check(gen) -> list[dict]:
    """Each new kernel that takes a shape, against plain at ATTN_TOL over the edges."""
    cases = [(3, 2, lk, hd, gated) for lk in EDGE_KEYS for hd in (64, 96)
             for gated in (True, False)]
    cases += [(3, 2, lk, hd, False) for lk in WIDE_EDGE_KEYS for hd in (136, 192, 200, 256)]
    cases += [(1, 1, 499, 64, True), (1, 1, 1499, 96, False), (1, 1, 1499, 256, False),
              (32, 12, 499, 64, True), (2, 12, 1499, 64, True), (2, 4, 1499, 192, False)]
    out, bad = [], []
    for b, h, lk, hd, gated in cases:
        for dt in (torch.bfloat16, torch.float16):
            lq = lk + 3 if lk < 2000 else lk - 61
            q, k, v, kb, gate, pos = inputs(gen, b, lq, lk, h, hd, dt, gated, masked=True)
            ref = plain(q, k, v, kb, gate, pos)
            for kernel in WA.onepass_kernels(lk, hd, gated, dt)[1:]:
                tag = f"{kernel} B={b} H={h} {lq}x{lk} hd={hd} {'gated ' if gated else ''}{dt}"
                try:
                    got = call(kernel, q, k, v, kb, gate, pos)
                    torch.cuda.synchronize()
                    err, med = C.compare(tag, got, ref, C.ATTN_TOL[dt])
                    out.append(dict(case=tag, max_abs_err=err, median=med))
                except (AssertionError, RuntimeError) as e:
                    bad.append(tag)
                    print(f"  FAIL {tag}: {e}", flush=True)
                    if isinstance(e, RuntimeError):
                        raise
            del q, k, v, kb, gate, pos, ref
    print(f"check: {len(out)} cases within ATTN_TOL, {len(bad)} outside", flush=True)
    if bad:
        raise SystemExit(1)
    return out


def shapes():
    """(label, B, L, H, hd, gated, dtype): rows 6 and 7 at the paths'
    shapes, then ladders."""
    served = bucket_frames(MEASURED_BUCKET_BATCH)
    bf, f16 = torch.bfloat16, torch.float16
    out = [(f"row 6 served {sec:g} s", MEASURED_BUCKET_BATCH[sec], l, 12, 64, True, bf)
           for sec, l in served.items() if l >= 128]
    out += [("row 6 extraction", 8, 499, 12, 64, True, bf),
            ("row 6 phase 3", 4, 249, 12, 64, True, bf),
            ("row 6 phase 3", 4, 499, 12, 64, True, bf),
            ("row 6 30 s", 2, 1499, 12, 64, True, bf),
            ("row 6 30 s", 2, 1499, 12, 64, True, f16),
            ("row 6 B=1", 1, 499, 12, 64, True, bf),
            ("row 7 30 s", 2, 1499, 8, 96, False, bf),
            ("row 7 30 s", 2, 1499, 8, 96, False, f16),
            ("row 7 eval", 16, 1951, 4, 64, False, bf),
            ("row 7 eval", 16, 1951, 4, 64, False, f16),
            ("row 7 hd 192", 2, 1499, 4, 192, False, bf),
            ("row 7 hd 192", 2, 1499, 4, 192, False, f16),
            ("row 7 hd 256", 16, 1951, 1, 256, False, bf),
            ("row 7 hd 256", 16, 1951, 1, 256, False, f16),
            ("row 7 hd 32", 16, 1951, 8, 32, False, bf),
            ("row 7 hd 128", 16, 1951, 2, 128, False, bf),
            ("row 7 hd 136", 2, 1499, 4, 136, False, bf)]
    for lk in (65, 128, 256, 257, 512, 513, 768, 1024, 2048):
        for hd, gated, h in ((64, True, 12), (96, False, 8)):
            out.append(("ladder", 4, lk, h, hd, gated, bf))
    for lk in (128, 512, 1024, 2048):
        out.append(("ladder", 4, lk, 4, 192, False, bf))
        out.append(("ladder", 4, lk, 1, 256, False, bf))
    for b in (1, 4, 8, 32):
        out.append(("ladder", b, 1499, 12, 64, True, bf))
    for b in (1, 3, 4, 8):
        out.append(("ladder", b, 1499, 8, 96, False, bf))
        out.append(("ladder", b, 1499, 4, 192, False, bf))
    for b in (2, 4, 8):
        out.append(("ladder", b, 1951, 4, 64, False, bf))
    for b in (8, 12, 32):
        out.append(("ladder", b, 1951, 1, 256, False, bf))
    for b in (2, 4):
        out.append(("ladder", b, 1499, 4, 256, False, bf))
    return out


def sweep(gen, repeats) -> list[dict]:
    out = []
    for label, b, l, h, hd, gated, dt in shapes():
        q, k, v, kb, gate, pos = inputs(gen, b, l, l, h, hd, dt, gated)
        amask = kb[:, None, None, :] if gate is None else \
            (gate[..., None] * pos.float()[None] + kb[:, None, None, :])
        amask = amask.to(dt)
        ms = {kn: C.cuda_ms(lambda kn=kn: call(kn, q, k, v, kb, gate, pos), repeats=repeats)
              for kn in WA.onepass_kernels(l, hd, gated, dt)}
        sdpa = C.cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=amask), repeats=repeats)
        picked = WA.onepass_route(q, k, v, gated)
        fastest = min(ms, key=ms.get)
        rec = dict(label=label, B=b, L=l, H=h, hd=hd, gated=gated, dtype=str(dt)[6:], ms=ms,
                   sdpa_ms=sdpa, picked=picked, fastest=fastest,
                   picked_over_fastest=ms[picked] / ms[fastest])
        out.append(rec)
        print(f"  {label:22s} B={b:3d} L={l:4d} {h:2d}x{hd:3d} {'gated' if gated else 'plain':5s} "
              f"{rec['dtype']:9s} " + "  ".join(f"{kn} {t:.4f}" for kn, t in ms.items())
              + f"  SDPA {sdpa:.4f}  picks {picked} ({rec['picked_over_fastest']:.3f} of the "
              f"fastest, {fastest})", flush=True)
        del q, k, v, kb, gate, pos, amask
        torch.cuda.empty_cache()
    return out


STREAM_EDGE_KEYS = (1, 127, 129, 2049, 2177, 2249, 4096)
STREAM_HEAD_DIMS = (32, 40, 64, 96, 104, 128, 136, 192, 200, 256)


def streaming_inputs(gen, b, lq, lk, h, hd, dt, masked=False):
    q, k, v, kb, _, _ = inputs(gen, b, lq, lk, h, hd, dt, False, masked)
    return q, k, v, kb


def streaming_check(gen) -> list[dict]:
    """Each wgmma kernel of the streaming core against plain at ATTN_TOL."""
    cases = [(3, 2, lk, hd) for lk in STREAM_EDGE_KEYS for hd in STREAM_HEAD_DIMS]
    cases += [(1, 1, 2249, 96), (2, 8, 2249, 96), (16, 4, 2267, 64), (2, 4, 2249, 192),
              (16, 1, 2267, 256), (16, 2, 2267, 128), (16, 8, 2267, 32)]
    out, bad = [], []
    for b, h, lk, hd in cases:
        for dt in (torch.bfloat16, torch.float16):
            lq = lk + 37 if lk < 2000 else lk - 61
            q, k, v, kb = streaming_inputs(gen, b, lq, lk, h, hd, dt, masked=True)
            ref = FA.streaming_attention_plain(q, k, v, kb)
            for kernel in FA.streaming_kernels(hd, dt)[1:]:
                tag = f"{kernel} B={b} H={h} {lq}x{lk} hd={hd} {dt}"
                try:
                    got = FA.streaming_attention(q, k, v, kb, kernel=kernel)
                    torch.cuda.synchronize()
                    err, med = C.compare(tag, got, ref, C.ATTN_TOL[dt])
                    out.append(dict(case=tag, max_abs_err=err, median=med))
                except AssertionError as e:
                    bad.append(tag)
                    print(f"  FAIL {tag}: {e}", flush=True)
            del q, k, v, kb, ref
    print(f"streaming check: {len(out)} cases within ATTN_TOL, {len(bad)} outside", flush=True)
    if bad:
        raise SystemExit(1)
    return out


def streaming_shapes():
    """(label, B, L, H, hd, dtype): row 8 at the paths' and phase 3's
    shapes, then ladders of key lengths, head dims and batches."""
    bf, f16 = torch.bfloat16, torch.float16
    out = [("row 8 45 s", 2, 2249, 8, 96, bf), ("row 8 45 s", 2, 2249, 8, 96, f16),
           ("row 8 eval", 16, 2267, 4, 64, bf), ("row 8 eval", 16, 2267, 4, 64, f16),
           ("row 8 hd 32", 16, 2267, 8, 32, bf), ("row 8 hd 128", 16, 2267, 2, 128, bf),
           ("row 8 hd 40", 16, 2267, 8, 40, bf), ("row 8 hd 192", 2, 2249, 4, 192, bf),
           ("row 8 hd 192", 2, 2249, 4, 192, f16), ("row 8 hd 256", 16, 2267, 1, 256, bf),
           ("row 8 hd 256", 16, 2267, 1, 256, f16)]
    for lk in (2049, 2560, 3072, 4096):
        for h, hd in ((8, 96), (4, 64), (2, 128), (4, 192), (1, 256)):
            out.append(("ladder", 2, lk, h, hd, bf))
    for hd, h in ((128, 2), (128, 6), (104, 2), (192, 4), (256, 1)):
        for b in (1, 2, 4, 8, 16, 32):
            out.append(("ladder", b, 2249, h, hd, bf))
    for b in (1, 4, 16):
        out.append(("ladder", b, 2249, 8, 96, bf))
        out.append(("ladder", b, 2249, 4, 64, bf))
        out.append(("ladder", b, 2249, 8, 32, bf))
    return out


def streaming_sweep(gen, repeats) -> list[dict]:
    out = []
    for label, b, l, h, hd, dt in streaming_shapes():
        q, k, v, kb = streaming_inputs(gen, b, l, l, h, hd, dt)
        amask = kb[:, None, None, :].to(dt)
        ms = {kn: C.cuda_ms(lambda kn=kn: FA.streaming_attention(q, k, v, kb, kernel=kn),
                            repeats=repeats)
              for kn in FA.streaming_kernels(hd, dt)}
        sdpa = C.cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=amask), repeats=repeats)
        picked = FA.streaming_route(q, k, v)
        fastest = min(ms, key=ms.get)
        ops = 4 * b * h * l * l * hd
        rec = dict(label=label, B=b, L=l, H=h, hd=hd, dtype=str(dt)[6:], ms=ms, sdpa_ms=sdpa,
                   picked=picked, fastest=fastest, picked_over_fastest=ms[picked] / ms[fastest],
                   bound_ms=C.bound(C.nbytes(q, k, v, kb, q), bf16_ops=ops)[0],
                   blocks128=b * h * -(-l // 128))
        out.append(rec)
        print(f"  {label:14s} B={b:3d} L={l:4d} {h:2d}x{hd:3d} {rec['dtype']:9s} "
              + "  ".join(f"{kn} {t:.4f}" for kn, t in ms.items())
              + f"  SDPA {sdpa:.4f}  bound {rec['bound_ms']:.4f}  picks {picked} "
              f"({rec['picked_over_fastest']:.3f} of the fastest, {fastest})", flush=True)
        del q, k, v, kb, amask
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--check", action="store_true",
                    help="hold the new kernels to plain at the edges, and stop")
    ap.add_argument("--streaming", action="store_true",
                    help="the streaming core (row 8) instead of the one-pass core")
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_onepass_routes: no CUDA device is available", file=sys.stderr)
        return 2
    smi = card()
    print(smi, flush=True)
    seconds = _cuda.build_all()
    print(f"build: {seconds}", flush=True)
    gen = torch.Generator().manual_seed(C.SEED + 24)
    out = dict(card=smi, ptxas=ptxas())
    if args.check:
        out["check"] = (streaming_check if args.streaming else check)(gen)
    else:
        out["sweep"] = (streaming_sweep if args.streaming else sweep)(gen, args.repeats)
    C.OUT.mkdir(exist_ok=True)
    name = "streaming_routes_h100.json" if args.streaming else "onepass_routes_h100.json"
    (C.OUT / name).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
