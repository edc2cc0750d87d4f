#!/usr/bin/env python3
"""Where the W8A8 projections' fused route beats the chain, by rows.

    python3 chip_proj_routes.py [--split] [--repeats N]

Run from the repository root on a machine with one NVIDIA GPU and ``nvcc``;
it takes its timing from ``chip_smoke.py`` (CUDA-event ms of a CUDA graph of
20 calls, the median of N replays). Without ``--split`` it runs each
projection of the path (csrc/proj_int8.cu: the WavLM sublayer's q/k/v
projection, its out-projection with the LayerNorm, and ``int8_linear`` at
every (N, K) of the served forward) on both routes over a ladder of rows,
each block configuration that spans N: the store forms bit-equal to the
chain, the LayerNorm form's largest difference from it; the gated core at
the served key lengths on its score panel beside the two-sweep kernel and
SDPA, each held to its plain version at ``ATTN_TOL``;
and the sublayer on both routes at the served shapes. Each line names the
grid's waves over the card, the route that ``_cuda.proj_route`` picks and
whether it was the faster. ``--split`` times each launch of the
WavLM attention sublayer's chain alone (row quantize of x, the q/k/v GEMM,
the gated core with SDPA beside it, row quantize of ctx, the out-projection,
the LayerNorm) at the bench's served shapes (1.25 s at B=384, 5 s at B=64,
10 s at B=32), and lists ``int8_linear``'s calls in one eager forward of the
served int8 stack by (M, N, K) at the same buckets. Prints the card's name
and power limit first and a JSON line of every reading last.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as C
from hriemo_torch import bench as HB
from hriemo_torch.frontends import WavLMConfig, WavLMEncoder
from hriemo_torch.infer.streaming import MEASURED_BUCKET_BATCH
from hriemo_torch.ops import _cuda
from hriemo_torch.ops import attention_block as AB
from hriemo_torch.ops import quant as Q

# (bucket seconds, batch, frames) of the served WavLM attention sublayer
SERVED_ATTN = ((1.25, 384, 62), (5.0, 64, 249), (10.0, 32, 499))


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def attn_layer(gen):
    enc = WavLMEncoder(WavLMConfig(num_hidden_layers=1))
    enc.init_weights(gen)
    return C.quantized(enc.encoder.layers[0])


def attn_inputs(gen, b, l, d=768, h=12):
    x = torch.randn(b, l, d, generator=gen).to("cuda", torch.bfloat16)
    pos = (0.3 * torch.randn(h, l, l, generator=gen)).to("cuda", torch.bfloat16)
    lens = torch.randint(l // 2, l + 1, (b,), generator=gen)
    lens[0] = l
    kb = torch.where(torch.arange(l)[None, :] >= lens[:, None], AB.NEG_INF, 0.0).float().cuda()
    return x, pos, kb


def chain_split(gen, repeats):
    """Each launch of today's chain alone, and the sublayer, at the served shapes."""
    layer = attn_layer(gen)
    ops, m_ops = layer.attn_ops, layer.attn_ops.mha
    out = []
    for sec, b, l in SERVED_ATTN:
        d, h = 768, 12
        hd = d // h
        x, pos, kb = attn_inputs(gen, b, l)
        x2 = x.view(b * l, d)
        xq, xs = _cuda.rowquant(x2, div127=False)
        qkv = _cuda.int8_gemm(xq, xs, m_ops.w_in, m_ops.s_in, m_ops.b_in, _cuda.EPI_BF16)
        q, k, v = qkv.split(d, dim=1)
        gate = (x2, ops.wg, ops.bg, ops.gconst, pos)
        ctx = AB.attention_core_int8(q, k, v, b, h, kbias=kb, gate=gate, panel=False)
        cq, cs = _cuda.rowquant(ctx, div127=False)
        y = _cuda.int8_gemm(cq, cs, m_ops.w_out, m_ops.s_out, m_ops.b_out,
                            _cuda.EPI_RESID_LAST, resid=x2)
        qh, kh, vh = (t.view(b, l, h, hd).transpose(1, 2) for t in (q, k, v))
        amask = (AB._gate(x2, ops.wg, ops.bg, ops.gconst, b, l, h) * pos.float()[None]
                 + kb[:, None, None, :]).to(torch.bfloat16)
        calls = {
            "sublayer": lambda: AB.attention_block_int8(x, ops, pos, kb, 1e-5, route="chain"),
            "rowquant x": lambda: _cuda.rowquant(x2, div127=False),
            "qkv GEMM": lambda: _cuda.int8_gemm(xq, xs, m_ops.w_in, m_ops.s_in, m_ops.b_in,
                                                _cuda.EPI_BF16),
            "core": lambda: AB.attention_core_int8(q, k, v, b, h, kbias=kb, gate=gate, panel=False),
            "rowquant ctx": lambda: _cuda.rowquant(ctx, div127=False),
            "out GEMM": lambda: _cuda.int8_gemm(cq, cs, m_ops.w_out, m_ops.s_out, m_ops.b_out,
                                                _cuda.EPI_RESID_LAST, resid=x2),
            "layernorm": lambda: _cuda.layernorm(y, ops.ln_w, ops.ln_b, 1e-5, x.dtype),
            "SDPA (core's yardstick)": lambda: torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=amask, scale=1.0),
        }
        ms = {name: C.cuda_ms(fn, repeats=repeats) for name, fn in calls.items()}
        launches = sum(ms[n] for n in ("rowquant x", "qkv GEMM", "core", "rowquant ctx",
                                       "out GEMM", "layernorm"))
        rec = dict(bucket=sec, B=b, L=l, M=b * l, ms=ms, launches_summed_ms=launches)
        out.append(rec)
        print(f"row 1 at {sec} s (B={b}, L={l}, M={b * l}): "
              + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
              + f"; six launches summed {launches:.4f} ms", flush=True)
        del x, pos, kb, x2, xq, qkv, q, k, v, ctx, cq, y, amask
        torch.cuda.empty_cache()
    return out


def linear_shapes():
    """int8_linear's calls in one eager forward of the served int8 stack, by
    (M, N, K), at each bucket of SERVED_ATTN."""
    models = HB.build_serving_models(C.SEED)
    pipe = HB.serving_pipeline(models, cuda_graphs=False)
    rng = np.random.default_rng(C.SEED)
    out = {}
    for sec, _, _ in SERVED_ATTN:
        b = MEASURED_BUCKET_BATCH[sec]
        args = HB.bucket_inputs(pipe, b, sec, HB.BUCKET_LT[sec], rng)
        pipe._forward(*args)
        Q.int8_linear.shapes.clear()
        with torch.no_grad():
            pipe._forward(*args)
        torch.cuda.synchronize()
        shapes = sorted(Q.int8_linear.shapes.items())
        out[sec] = [dict(M=m, N=n, K=k, calls=c) for (m, n, k), c in shapes]
        print(f"int8_linear in one forward at {sec} s (B={b}): "
              + ", ".join(f"{c} x (M={m}, N={n}, K={k})" for (m, n, k), c in shapes), flush=True)
    del pipe, models
    torch.cuda.empty_cache()
    return out


LADDER = (128, 256, 512, 1024, 1536, 1996, 3072, 4096, 8192, 15968, 23808)
# (form, N, K, x dtype, rows): the q/k/v projection, int8_linear at each
# (N, K) of the served forward (decoder 768 -> 768, its FFN 768 -> 2048 ->
# 768, the feature projection 512 -> 768), the out-projection with the LN
PROJ_SHAPES = (
    ("qkv", 2304, 768, torch.bfloat16, LADDER),
    ("linear", 768, 768, torch.bfloat16, LADDER),
    ("linear", 768, 512, torch.bfloat16, LADDER),
    ("linear", 2048, 768, torch.bfloat16, (128, 256, 1536)),
    ("linear", 768, 2048, torch.bfloat16, (128, 256, 1536)),
    ("linear", 768, 768, torch.float32, (1996, 15968)),
    ("out+LN", 768, 768, torch.bfloat16, LADDER),
    ("out+LN", 768, 768, torch.float32, (1996, 15968)),
)
# the gated core's key lengths: the served buckets' (1.25 s, 5 s, 10 s at
# their batches), phase 4's (2.5 s, 10 s at B=4) and the panel's edges
CORE_SHAPES = ((384, 62), (256, 93), (192, 124), (128, 155), (128, 187), (64, 218),
               (64, 249), (64, 280), (32, 499), (4, 124), (4, 499), (4, 63), (4, 512))


def gated_qkv(gen, b, l, ops, d=768, h=12):
    hd = d // h
    qkv = torch.randn(b * l, 3 * d, generator=gen).to("cuda", torch.bfloat16)
    qkv[:, :d] *= hd ** -0.5
    q, k, v = qkv.split(d, dim=1)
    x, pos, kb = attn_inputs(gen, b, l)
    return q, k, v, kb, (x.view(b * l, d), ops.wg, ops.bg, ops.gconst, pos)


def route_sweep(gen, repeats):
    layer = attn_layer(gen)
    ops, m_ops = layer.attn_ops, layer.attn_ops.mha
    sms = _cuda.sm_count()
    out = dict(projections=[], core=[], sublayer=[])
    for form, n, k, dt, rows in PROJ_SHAPES:
        w = torch.randint(-127, 128, (n, k), generator=gen, dtype=torch.int8).cuda()
        ws = (torch.rand(n, 1, generator=gen) * 1e-3 + 1e-5).cuda()
        bias = torch.randn(n, generator=gen).cuda()
        ln_w, ln_b = (torch.rand(n, generator=gen) + 0.5).cuda(), torch.randn(n, generator=gen).cuda()
        ob = 2 if form == "qkv" else dt.itemsize
        for m in rows:
            x = torch.randn(m, k, generator=gen).to("cuda", torch.bfloat16 if form == "out+LN" else dt)
            resid = torch.randn(m, n, generator=gen).to("cuda", dt)
            if form == "qkv":
                fused = lambda c: _cuda.proj_gemm(x, w, ws, bias, _cuda.EPI_BF16, False, config=c)
                chain = lambda: _cuda.int8_gemm(*_cuda.rowquant(x, div127=False), w, ws, bias,
                                                _cuda.EPI_BF16)
            elif form == "linear":
                fused = lambda c: _cuda.proj_gemm(x, w, ws, bias, _cuda.out_epi(dt), True, config=c)
                chain = lambda: _cuda.int8_gemm(*_cuda.rowquant(x, div127=True), w, ws, bias,
                                                _cuda.out_epi(dt))
            else:
                fused = lambda c: _cuda.proj_gemm_ln(x, w, ws, bias, resid, ln_w, ln_b, 1e-5,
                                                     config=c)
                chain = lambda: _cuda.layernorm(_cuda.int8_gemm(
                    *_cuda.rowquant(x, div127=False), w, ws, bias, _cuda.EPI_RESID_LAST,
                    resid=resid), ln_w, ln_b, 1e-5, dt)
            ref = chain()
            rec = dict(form=form, N=n, K=k, dtype=str(dt)[6:], m=m,
                       chain_ms=C.cuda_ms(chain, repeats=repeats), fused_ms={}, waves={})
            for c in (0, 1):
                cl = _cuda.proj_cluster(n, k, ob, config=c)
                if cl is None:
                    continue
                got = fused(c)
                diff = (got.float() - ref.float()).abs().max().item()
                if form != "out+LN" and diff != 0:
                    raise AssertionError(f"{form} N={n} K={k} M={m} config {c}: differs from "
                                         f"the chain by {diff}")
                rec.setdefault("max_diff", {})[c] = diff
                rec["fused_ms"][c] = C.cuda_ms(lambda c=c: fused(c), repeats=repeats)
                rec["waves"][c] = -(-m // 64) * cl[1] / sms
            picked = _cuda.proj_route(n, m, k, ob, sms)
            default = _cuda.proj_cluster(n, k, ob)
            best = min([rec["chain_ms"], *rec["fused_ms"].values()])
            t_picked = rec["chain_ms"] if picked == "chain" else rec["fused_ms"][default[0]]
            rec.update(picked=picked, picked_faster=t_picked <= best)
            out["projections"].append(rec)
            print(f"{form:7s} {k:5d}->{n:5d} {rec['dtype']:8s} M={m:6d}: chain "
                  f"{rec['chain_ms']:.4f} ms; fused " + ", ".join(
                      f"config {c} {t:.4f} ms ({t / rec['chain_ms']:.3f} of the chain, waves "
                      f"{rec['waves'][c]:.2f})" for c, t in rec["fused_ms"].items())
                  + f"; max |d| {rec.get('max_diff')}; picks {picked}"
                  + ("" if rec["picked_faster"] else " (not the fastest)"), flush=True)
            del x, resid, ref
        torch.cuda.empty_cache()
    h = 12
    for b, l in CORE_SHAPES:
        q, k, v, kb, gate = gated_qkv(gen, b, l, ops)
        plain = AB.attention_core_int8_plain(q, k, v, b, h, kbias=kb, gate=gate)
        rec = dict(B=b, L=l, ms={}, err={})
        for name, panel in (("two sweeps", False), ("panel", True)):
            fn = lambda panel=panel: AB.attention_core_int8(q, k, v, b, h, kbias=kb, gate=gate,
                                                            panel=panel)
            rec["err"][name] = C.compare(f"core B={b} L={l} {name}", fn(), plain,
                                         C.ATTN_TOL[torch.bfloat16])[0]
            rec["ms"][name] = C.cuda_ms(fn, repeats=repeats)
        qh, kh, vh = (t.view(b, l, h, -1).transpose(1, 2) for t in (q, k, v))
        x2, _, _, _, pos = gate
        amask = (AB._gate(*gate[:4], b, l, h) * pos.float()[None]
                 + kb[:, None, None, :]).to(torch.bfloat16)
        rec["ms"]["SDPA"] = C.cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=amask, scale=1.0), repeats=repeats)
        out["core"].append(rec)
        print(f"gated core B={b} L={l}: " + ", ".join(f"{n} {t:.4f} ms" for n, t in
                                                      rec["ms"].items())
              + f"; max |d| vs plain {rec['err']}", flush=True)
        del q, k, v, kb, gate, plain, amask
        torch.cuda.empty_cache()
    for b, l in ((384, 62), (128, 187), (64, 249), (32, 499), (48, 62), (32, 62), (4, 499),
                 (4, 124)):
        x, pos, kb = attn_inputs(gen, b, l)
        plain = AB.attention_block_int8_plain(x, ops, pos, kb, 1e-5)
        rec = dict(B=b, L=l, M=b * l, ms={}, err={},
                   picked=AB.attention_route(b * l, 768, 2, sms))
        for route in ("fused", "chain"):
            fn = lambda route=route: AB.attention_block_int8(x, ops, pos, kb, 1e-5, route=route)
            rec["err"][route] = C.compare(f"sublayer B={b} L={l} {route}", fn(), plain)[0]
            rec["ms"][route] = C.cuda_ms(fn, repeats=repeats)
        out["sublayer"].append(rec)
        print(f"sublayer B={b} L={l} (M={b * l}): fused {rec['ms']['fused']:.4f} ms, chain "
              f"{rec['ms']['chain']:.4f} ms; max |d| vs plain {rec['err']}; picks "
              f"{rec['picked']}", flush=True)
        del x, pos, kb, plain
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--split", action="store_true",
                    help="time each launch of the sublayer's chain and list int8_linear's calls")
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_proj_routes: no CUDA device is available", file=sys.stderr)
        return 2
    smi = card()
    print(smi, flush=True)
    _cuda.build_all()
    gen = torch.Generator().manual_seed(C.SEED + 23)
    out = dict(card=smi)
    if args.split:
        out["chain_split"] = chain_split(gen, args.repeats)
        out["int8_linear_shapes"] = linear_shapes()
    else:
        out.update(route_sweep(gen, args.repeats))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
