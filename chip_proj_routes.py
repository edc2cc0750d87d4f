#!/usr/bin/env python3
"""Where the W8A8 projections' fused route beats the chain, by rows.

    python3 chip_proj_routes.py [--split | --mha | --mha-routes | --mha-model | --cores]
                                [--repeats N]

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
served int8 stack by (M, N, K) at the same buckets. ``--mha`` times each
launch of the MHA sublayer (csrc/proj_int8.cu, csrc/attention.cu) on both
routes at every call site of the served buckets (BERT self; the fusion
stack's audio self, text self, audio->text, text->audio), beside the
caller's plain ``layer_norm(x + y)`` and SDPA for the core, with the store
forms' bit-equality and the LayerNorm form's largest difference from the
chain, then the ungated core on its score panel against the two sweeps at
the served audio key lengths; ``--mha-routes`` times both routes of each call site over a ladder of
batches, with the caller's LayerNorm and without; ``--mha-model`` prints the
readings behind ``AB.mha_route``'s estimate with the LayerNorm (clusters
the card runs at once, each projection and the out-projection with the
LayerNorm on both routes by rows beside the estimate, both routes of the MHA
where they come close); ``--cores`` times the int8 core's three kernels
(the two sweeps, the score panel, the wgmma warpgroups) beside SDPA and
the plain version at every served WavLM length at its served batch and at
B = 1 and 4 (3.75 s, 10 s), gated 12 x 64 and ungated 8 x 96, and counts
the compiled instructions of each kernel at head dim 64. Prints the card's name
and power limit first and a JSON line of every reading last.
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as C
from hriemo_torch import bench as HB
from hriemo_torch.frontends import WavLMConfig, WavLMEncoder
from hriemo_torch.infer.streaming import MEASURED_BUCKET_BATCH
from hriemo_torch.nn.attention import MultiheadAttention
from hriemo_torch.nn.layers import init_torch_defaults, layer_norm
from hriemo_torch.ops import _cuda
from hriemo_torch.ops import attention_block as AB
from hriemo_torch.ops import quant as Q

# (bucket seconds, batch, frames) of the served WavLM attention sublayer
SERVED_ATTN = ((1.25, 384, 62), (5.0, 64, 249), (10.0, 32, 499))
# (bucket seconds, batch, audio frames, text tokens) of the served MHA
# sublayers (HB.BUCKET_LT, MEASURED_BUCKET_BATCH)
SERVED_MHA = ((1.25, 384, 62, 8), (5.0, 64, 249, 20), (10.0, 32, 499, 64))
# the MHA sublayer's call sites of a served forward: (name, heads, query
# length, key length) with "a" the audio frames and "t" the text tokens; the
# LayerNorm's eps of each caller (BERT 1e-12, the fusion layers 1e-5)
MHA_SITES = (("BERT self", 12, "t", "t", 1e-12), ("audio self", 8, "a", "a", 1e-5),
             ("text self", 8, "t", "t", 1e-5), ("audio->text", 8, "a", "t", 1e-5),
             ("text->audio", 8, "t", "a", 1e-5))


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
        ctx = AB.attention_core_int8(q, k, v, b, h, kbias=kb, gate=gate, kernel="sweeps")
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
            "core": lambda: AB.attention_core_int8(q, k, v, b, h, kbias=kb, gate=gate,
                                                   kernel="sweeps"),
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


def mha_case(gen, mods, b, la, lt, h, q_of, k_of, eps, d=768):
    """Inputs of one MHA call site: xq, xkv (xq itself for self-attention),
    the key padding mask (element 0 full, the others padded at random) and
    the caller's LayerNorm (bf16 values, as on the served bf16 tree, in the
    fp32 copies that ``LayerNorm.norm`` hands the kernel)."""
    lq, lk = (la if w == "a" else lt for w in (q_of, k_of))
    if h not in mods:
        mod = MultiheadAttention(d, h)
        init_torch_defaults(mod, gen)
        mods[h] = C.quantized(mod).ops
    xq = torch.randn(b, lq, d, generator=gen).to("cuda", torch.bfloat16)
    xkv = xq if q_of == k_of else torch.randn(b, lk, d, generator=gen).to("cuda", torch.bfloat16)
    lens = torch.randint(max(1, lk // 2), lk + 1, (b,), generator=gen)
    lens[0] = lk
    kpm = (torch.arange(lk)[None, :] >= lens[:, None]).cuda()
    ln_w = (torch.rand(d, generator=gen) + 0.5).to("cuda", torch.bfloat16).float()
    ln_b = (0.1 * torch.randn(d, generator=gen)).to("cuda", torch.bfloat16).float()
    return mods[h], xq, xkv, kpm, (ln_w, ln_b, eps), lq, lk


def mha_forms(xq, xkv, ops, kpm, norm):
    """The fused route against the chain, the core on the two sweeps on
    both: the store forms bit-equal (raises otherwise), the LayerNorm form's
    largest difference and the share of its elements that differ."""
    def both(nm):
        return [C.mha_fused_two_sweeps(xq, xkv, ops, kpm, nm),
                AB.mha_block_int8(xq, xkv, ops, kpm, nm, route="chain")]
    fused, chain = both(None)
    if not torch.equal(fused, chain):
        raise AssertionError(f"MHA {tuple(xq.shape)} x {tuple(xkv.shape)}: the fused store form "
                             f"differs from the chain by {(fused - chain).abs().max().item()}")
    fused, chain = both(norm)
    diff = (fused.float() - chain.float()).abs()
    return dict(store_bit_equal=True, ln_max_abs_diff=diff.max().item(),
                ln_share_differing=(diff > 0).float().mean().item())


# the ungated core's key lengths: the audio frames of every bucket at its
# served batch (audio self: Lq = Lk; text -> audio: the bucket's text tokens
# as queries), and the panel's longest row
MHA_CORE_SHAPES = ((384, 62, 8), (256, 93, 12), (192, 124, 12), (128, 155, 16),
                   (128, 187, 16), (64, 218, 20), (64, 249, 20), (64, 280, 24),
                   (64, 312, 24), (64, 343, 32), (64, 374, 32), (32, 405, 32),
                   (32, 436, 32), (32, 499, 64), (32, 512, 64))


def mha_core_sweep(gen, repeats):
    """The ungated core (8 heads of 96) on its score panel beside the
    two-sweep kernel and SDPA at the audio key lengths of the served
    buckets, audio self and text -> audio, each held to its plain version at
    ``ATTN_TOL``."""
    out, h, d = [], 8, 768
    for b, la, lt in MHA_CORE_SHAPES:
        for site, lq in (("audio self", la), ("text->audio", lt)):
            q = torch.randn(b * lq, d, generator=gen).to("cuda", torch.bfloat16) * 96 ** -0.5
            kv = torch.randn(b * la, 2 * d, generator=gen).to("cuda", torch.bfloat16)
            k, v = kv.split(d, dim=1)
            lens = torch.randint(la // 2, la + 1, (b,), generator=gen)
            lens[0] = la
            kpm = (torch.arange(la)[None, :] >= lens[:, None]).cuda()
            plain = AB.attention_core_int8_plain(q, k, v, b, h, kpm=kpm)
            rec = dict(site=site, B=b, Lq=lq, Lk=la, ms={}, err={},
                       picked=AB.core_kernel(la, False, 96, b))
            for name in AB.CORE_KERNELS:
                fn = lambda name=name: AB.attention_core_int8(q, k, v, b, h, kpm=kpm,
                                                              kernel=name)
                rec["err"][name] = C.compare(f"core {site} B={b} {lq}x{la} {name}", fn(),
                                             plain, C.ATTN_TOL[torch.bfloat16])[0]
                rec["ms"][name] = C.cuda_ms(fn, repeats=repeats)
            qh = q.view(b, lq, h, -1).transpose(1, 2)
            kh, vh = (t.reshape(b, la, h, -1).transpose(1, 2) for t in (k, v))
            rec["ms"]["SDPA"] = C.cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=~kpm[:, None, None, :], scale=1.0), repeats=repeats)
            out.append(rec)
            print(f"ungated core {site} B={b} {lq}x{la}: " + ", ".join(
                f"{n} {t:.4f} ms" for n, t in rec["ms"].items())
                + f"; max |d| vs plain {rec['err']}; takes {rec['picked']}", flush=True)
            del q, kv, k, v, kpm, plain, qh, kh, vh
        torch.cuda.empty_cache()
    return out


def mha_split(gen, repeats):
    """Each launch of the MHA sublayer's chain alone at every call site of
    the served buckets, beside the caller's plain ``layer_norm(x + y)`` and
    SDPA on the core's q/k/v."""
    mods, out = {}, []
    for sec, b, la, lt in SERVED_MHA:
        for site, h, q_of, k_of, eps in MHA_SITES:
            d = 768
            ops, xq, xkv, kpm, norm, lq, lk = mha_case(gen, mods, b, la, lt, h, q_of, k_of, eps)
            self_attn = xkv is xq
            x2, kv2 = xq.view(b * lq, d), xkv.view(b * lk, d)
            aq, aqs = _cuda.rowquant(x2, div127=False)
            ak, aks = _cuda.rowquant(kv2, div127=False)
            if self_attn:
                qkv = _cuda.int8_gemm(aq, aqs, ops.w_in, ops.s_in, ops.b_in, _cuda.EPI_BF16)
                q, k, v = qkv.split(d, dim=1)
            else:
                q = _cuda.int8_gemm(aq, aqs, ops.w_in, ops.s_in, ops.b_in, _cuda.EPI_BF16,
                                    w_rows=(0, d))
                k, v = _cuda.int8_gemm(ak, aks, ops.w_in, ops.s_in, ops.b_in, _cuda.EPI_BF16,
                                       w_rows=(d, 2 * d)).split(d, dim=1)
            ctx = AB.attention_core_int8(q, k, v, b, h, kpm=kpm, kernel="sweeps")
            cq, cs = _cuda.rowquant(ctx, div127=False)
            y = _cuda.int8_gemm(cq, cs, ops.w_out, ops.s_out, ops.b_out, _cuda.EPI_BF16)
            qh = q.view(b, lq, h, -1).transpose(1, 2)
            kh, vh = (t.view(b, lk, h, -1).transpose(1, 2) for t in (k, v))
            amask = ~kpm[:, None, None, :]
            calls = {"chain + LN": lambda: AB.mha_block_int8(xq, xkv, ops, kpm, norm,
                                                             route="chain"),
                     "fused + LN": lambda: AB.mha_block_int8(xq, xkv, ops, kpm, norm,
                                                             route="fused"),
                     "rowquant xq": lambda: _cuda.rowquant(x2, div127=False)}
            if self_attn:
                calls["q/k/v GEMM"] = lambda: _cuda.int8_gemm(aq, aqs, ops.w_in, ops.s_in,
                                                              ops.b_in, _cuda.EPI_BF16)
            else:
                calls["rowquant xkv"] = lambda: _cuda.rowquant(kv2, div127=False)
                calls["q GEMM"] = lambda: _cuda.int8_gemm(aq, aqs, ops.w_in, ops.s_in, ops.b_in,
                                                          _cuda.EPI_BF16, w_rows=(0, d))
                calls["k/v GEMM"] = lambda: _cuda.int8_gemm(ak, aks, ops.w_in, ops.s_in,
                                                            ops.b_in, _cuda.EPI_BF16,
                                                            w_rows=(d, 2 * d))
            calls.update({
                "core": lambda: AB.attention_core_int8(q, k, v, b, h, kpm=kpm, kernel="sweeps"),
                "rowquant ctx": lambda: _cuda.rowquant(ctx, div127=False),
                "out GEMM": lambda: _cuda.int8_gemm(cq, cs, ops.w_out, ops.s_out, ops.b_out,
                                                    _cuda.EPI_BF16),
                "plain LN(x + y)": lambda: layer_norm(xq + y.view(b, lq, d), *norm),
                "SDPA (core's yardstick)": lambda: torch.nn.functional.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=amask, scale=1.0)})
            if self_attn:
                calls["fused: q/k/v projection"] = lambda: _cuda.proj_gemm(
                    x2, ops.w_in, ops.s_in, ops.b_in, _cuda.EPI_BF16, div127=False)
            else:
                calls["fused: q projection"] = lambda: _cuda.proj_gemm(
                    x2, ops.w_in[:d], ops.s_in[:d], ops.b_in[:d], _cuda.EPI_BF16, div127=False)
                calls["fused: k/v projection"] = lambda: _cuda.proj_gemm(
                    kv2, ops.w_in[d:], ops.s_in[d:], ops.b_in[d:], _cuda.EPI_BF16, div127=False)
            calls[f"fused: core ({AB.core_kernel(lk, False, d // h, b)})"] = \
                lambda: AB.attention_core_int8(q, k, v, b, h, kpm=kpm)
            ln32 = (norm[0].float(), norm[1].float(), norm[2])
            calls["fused: out-projection + LN"] = lambda: _cuda.proj_gemm_ln(
                ctx, ops.w_out, ops.s_out, ops.b_out, x2, ln32[0], ln32[1], eps, rounded=True)
            ms = {name: C.cuda_ms(fn, repeats=repeats) for name, fn in calls.items()}
            summed = sum(t for n, t in ms.items() if not n.startswith(("fused", "chain", "SDPA")))
            rec = dict(bucket=sec, site=site, B=b, Lq=lq, Lk=lk, H=h, ms=ms,
                       launches_summed_ms=summed, picked=AB.mha_route(
                           b, lq, lk, d, h, 2, True, not self_attn, _cuda.sm_count()),
                       **mha_forms(xq, xkv, ops, kpm, norm))
            out.append(rec)
            print(f"row 2 at {sec} s, {site} (B={b}, {lq}x{lk}, H={h}): "
                  + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
                  + f"; chain launches summed {summed:.4f} ms; picks {rec['picked']}; store "
                  f"forms bit-equal, the LN form max |d| {rec['ln_max_abs_diff']:.4g} "
                  f"({rec['ln_share_differing']:.4%} of elements differ)", flush=True)
            del xq, xkv, kpm, x2, kv2, aq, ak, q, k, v, ctx, cq, y, qh, kh, vh, amask
            torch.cuda.empty_cache()
    return out


MHA_LADDER = (1, 2, 4, 8, 16, 32, 64, 128, 384)


def mha_route_sweep(gen, repeats):
    """Each call site of the served buckets' lengths on both routes, with
    the caller's LayerNorm and without, over a ladder of batches (rows): ms
    of each, the waves of the out-projection's cluster grid, the route that
    ``AB.mha_route`` picks and whether it was the faster."""
    mods, out = {}, []
    sms = _cuda.sm_count()
    for sec, _, la, lt in SERVED_MHA:
        for site, h, q_of, k_of, eps in MHA_SITES:
            for b in MHA_LADDER:
                ops, xq, xkv, kpm, norm, lq, lk = mha_case(gen, mods, b, la, lt, h, q_of, k_of,
                                                           eps)
                cross = xkv is not xq
                cl = _cuda.proj_cluster(768, 768, 2)
                rec = dict(bucket=sec, site=site, B=b, Lq=lq, Lk=lk, M=b * lq,
                           waves=-(-b * lq // 64) * cl[1] / sms, ms={}, picked={})
                for nm, tag in ((norm, "LN"), (None, "store")):
                    for route in ("fused", "chain"):
                        rec["ms"][f"{route} {tag}"] = C.cuda_ms(
                            lambda route=route, nm=nm: AB.mha_block_int8(xq, xkv, ops, kpm, nm,
                                                                         route=route),
                            repeats=repeats)
                    picked = AB.mha_route(b, lq, lk, 768, h, 2, nm is not None, cross, sms)
                    t = {r: rec["ms"][f"{r} {tag}"] for r in ("fused", "chain")}
                    rec["picked"][tag] = (picked, t[picked] <= min(t.values()))
                out.append(rec)
                print(f"{sec} s {site} B={b} ({lq}x{lk}, M={b * lq}, waves {rec['waves']:.2f}): "
                      + ", ".join(f"{k} {v:.4f}" for k, v in rec["ms"].items())
                      + "; picks " + ", ".join(f"{k} {p}" + ("" if ok else " (not the faster)")
                                               for k, (p, ok) in rec["picked"].items()),
                      flush=True)
                del xq, xkv, kpm
            torch.cuda.empty_cache()
    return out


# rows of the route estimate's readings, and the MHA calls where its two
# routes come close: (B, Lq, Lk, heads, cross) at phase 3's batch and around
# it, cross-attention from few queries to 250-1000 keys
MODEL_ROWS = (64, 256, 512, 1024, 1536, 1920, 1984, 2048, 2560, 3072, 3968, 4096, 6144, 8192)
MODEL_MHA = ((1, 16, 499, 8, True), (2, 16, 499, 8, True), (4, 16, 499, 8, True),
             (8, 16, 499, 8, True), (4, 64, 499, 8, True), (8, 64, 499, 8, True),
             (4, 16, 250, 8, True), (4, 16, 1000, 8, True), (4, 499, 16, 8, True),
             (4, 499, 64, 8, True), (4, 16, 16, 12, False), (4, 64, 64, 12, False),
             (4, 499, 499, 8, False))


def mha_model(gen, repeats):
    """The readings behind ``AB.mha_route``'s estimate with the caller's
    LayerNorm: the clusters of each projection the card runs at once, each
    projection of the MHA (q ``d``, k/v ``2d``, q/k/v ``3d`` columns at K =
    768) that quantizes its own rows against the chain's row quantize and
    GEMM over a ladder of rows, the out-projection with the LayerNorm against
    the chain's out GEMM and plain ``layer_norm(x + y)``, each beside
    ``AB._proj_ms``'s estimate; then both routes of the MHA where they come
    close, with the route ``AB.mha_route`` picks."""
    d, sms = 768, _cuda.sm_count()
    out = dict(clusters=[], proj=[], out_ln=[], mha=[])
    for n in (d, 2 * d, 3 * d, 4 * d):
        for c in (0, 1):
            cl = _cuda.proj_cluster(n, d, 2, config=c)
            if cl is None:
                continue
            rec = dict(N=n, config=c, blocks=cl[1], proj=_cuda.proj_clusters(n, d, c))
            out["clusters"].append(rec)
            print(f"N={n} config {c}: {cl[1]} blocks a cluster, {rec['proj']} clusters at once",
                  flush=True)
    mods = {}
    ops, *_ = mha_case(gen, mods, 1, 62, 8, 8, "a", "t", 1e-5)
    w, s, bias = ops.w_in, ops.s_in, ops.b_in
    for n in (d, 2 * d, 3 * d):
        for m in MODEL_ROWS:
            x = torch.randn(m, d, generator=gen).to("cuda", torch.bfloat16)
            fused = C.cuda_ms(lambda: _cuda.proj_gemm(x, w[:n], s[:n], bias[:n], _cuda.EPI_BF16,
                                                      div127=False), repeats=repeats)

            def chain():
                a, sa = _cuda.rowquant(x, div127=False)
                return _cuda.int8_gemm(a, sa, w, s, bias, _cuda.EPI_BF16, w_rows=(0, n))
            rec = dict(N=n, M=m, fused_ms=fused, chain_ms=C.cuda_ms(chain, repeats=repeats),
                       est_fused_ms=AB._proj_ms(n, m, d, True, sms),
                       est_chain_ms=AB._proj_ms(n, m, d, False, sms))
            out["proj"].append(rec)
            print(f"projection {d}->{n} M={m}: fused {fused:.4f} (est {rec['est_fused_ms']:.4f}) "
                  f"chain {rec['chain_ms']:.4f} (est {rec['est_chain_ms']:.4f})", flush=True)
    ln = ((torch.rand(d, generator=gen) + 0.5).cuda(), (0.1 * torch.randn(d, generator=gen)).cuda(),
          1e-5)
    for m in MODEL_ROWS:
        ctx = torch.randn(m, d, generator=gen).to("cuda", torch.bfloat16)
        x = torch.randn(m, d, generator=gen).to("cuda", torch.bfloat16)

        def out_chain(with_ln):
            a, sa = _cuda.rowquant(ctx, div127=False)
            y = _cuda.int8_gemm(a, sa, ops.w_out, ops.s_out, ops.b_out, _cuda.EPI_BF16)
            return AB._add_norm(x, y, ln) if with_ln else y
        rec = dict(M=m, fused_ms=C.cuda_ms(lambda: _cuda.proj_gemm_ln(
            ctx, ops.w_out, ops.s_out, ops.b_out, x, *ln, rounded=True), repeats=repeats),
            chain_ln_ms=C.cuda_ms(lambda: out_chain(True), repeats=repeats),
            chain_store_ms=C.cuda_ms(lambda: out_chain(False), repeats=repeats))
        out["out_ln"].append(rec)
        print(f"out-projection + LN M={m}: fused {rec['fused_ms']:.4f}, chain + plain LN "
              f"{rec['chain_ln_ms']:.4f} (the chain's store {rec['chain_store_ms']:.4f})",
              flush=True)
    for b, lq, lk, h, cross in MODEL_MHA:
        xq = torch.randn(b, lq, d, generator=gen).to("cuda", torch.bfloat16)
        xkv = torch.randn(b, lk, d, generator=gen).to("cuda", torch.bfloat16) if cross else xq
        lens = torch.randint(lk // 2, lk + 1, (b,), generator=gen)
        lens[0] = lk
        kpm = (torch.arange(lk)[None, :] >= lens[:, None]).cuda()
        if h not in mods:
            mod = MultiheadAttention(d, h)
            init_torch_defaults(mod, gen)
            mods[h] = C.quantized(mod).ops
        ms = {r: C.cuda_ms(lambda r=r: AB.mha_block_int8(xq, xkv, mods[h], kpm, ln, route=r),
                           repeats=repeats) for r in ("fused", "chain")}
        picked = AB.mha_route(b, lq, lk, d, h, 2, True, cross, sms)
        out["mha"].append(dict(B=b, Lq=lq, Lk=lk, H=h, cross=cross, ms=ms, picked=picked))
        print(f"MHA with the LayerNorm, B={b} {'cross' if cross else 'self'} {lq}x{lk} H={h}: "
              f"fused {ms['fused']:.4f}, chain {ms['chain']:.4f}; picks {picked}"
              + ("" if ms[picked] <= min(ms.values()) else " (not the faster)"), flush=True)
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
        for name in AB.CORE_KERNELS:
            fn = lambda name=name: AB.attention_core_int8(q, k, v, b, h, kbias=kb, gate=gate,
                                                          kernel=name)
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


# the int8 core at every served WavLM length (the audio frames of the 14
# buckets, hriemo_torch.tools.kernel_numerics.bucket_frames) at its served
# batch (MEASURED_BUCKET_BATCH), and the thin grids B = 1 and 4 at 3.75 s and
# 10 s: WavLM's gated 12 x 64 and the fusion stack's ungated audio
# self-attention, 8 x 96
THIN_CORES = ((3.75, 1), (3.75, 4), (10.0, 1), (10.0, 4))


def core_cases():
    from hriemo_torch.tools.kernel_numerics import bucket_frames

    frames = bucket_frames(MEASURED_BUCKET_BATCH)
    return [(sec, MEASURED_BUCKET_BATCH[sec], frames[sec]) for sec in MEASURED_BUCKET_BATCH] + \
        [(sec, b, frames[sec]) for sec, b in THIN_CORES]


def core_inputs(gen, b, l, gated, ops):
    """q/k/v as column blocks of a packed projection (1/sqrt(hd) in q), the
    key bias (gated: fp32 -1e9 / 0 with the gate's x and pos) or the padding
    mask, and SDPA's materialised bias on the same inputs."""
    if gated:
        q, k, v, kb, gate = gated_qkv(gen, b, l, ops)
        amask = (AB._gate(*gate[:4], b, l, 12) * gate[4].float()[None]
                 + kb[:, None, None, :]).to(torch.bfloat16)
        return q, k, v, dict(kbias=kb, gate=gate), amask, 12
    h, d = 8, 768
    qkv = torch.randn(b * l, 3 * d, generator=gen).to("cuda", torch.bfloat16)
    qkv[:, :d] *= (d // h) ** -0.5
    q, k, v = qkv.split(d, dim=1)
    lens = torch.randint(l // 2, l + 1, (b,), generator=gen)
    lens[0] = l
    kpm = (torch.arange(l)[None, :] >= lens[:, None]).cuda()
    return q, k, v, dict(kpm=kpm), ~kpm[:, None, None, :], h


def core_bound_ms(b, l, h, hd, gated):
    """The least time of the core on this card: its bytes (q, k, v, ctx,
    pos, x and the key bias or mask, each once) at the HBM rate against its
    bf16 products (QK^T and PV) at the tensor-core rate."""
    rows = b * l * h * hd
    nbytes = 4 * rows * 2 + (h * l * l * 2 + rows * 2 + b * l * 4 if gated else b * l)
    return max(nbytes / C.PEAK_BYTES, 4 * b * h * l * l * hd / C.PEAK_BF16) * 1e3


def core_sweep(gen, repeats):
    """Each core kernel (the two sweeps, the panel, the wgmma warpgroups) and
    SDPA on the same q/k/v at every served WavLM length and the thin grids,
    gated 12 x 64 and ungated 8 x 96; each kernel held to the plain version
    at ``ATTN_TOL``; the kernel ``AB.core_kernel`` picks, and whether it was
    the fastest of the three."""
    ops = attn_layer(gen).attn_ops
    out = []
    for gated in (True, False):
        for sec, b, l in core_cases():
            q, k, v, kw, amask, h = core_inputs(gen, b, l, gated, ops)
            hd = 768 // h
            plain = AB.attention_core_int8_plain(q, k, v, b, h, **kw)
            rec = dict(gated=gated, bucket=sec, B=b, L=l, H=h, hd=hd, ms={}, err={},
                       picked=AB.core_kernel(l, gated, hd, b),
                       bound_ms=core_bound_ms(b, l, h, hd, gated))
            for name in AB.CORE_KERNELS:
                fn = lambda name=name: AB.attention_core_int8(q, k, v, b, h, kernel=name, **kw)
                rec["err"][name] = C.compare(f"core {'gated' if gated else 'ungated'} B={b} "
                                             f"L={l} {name}", fn(), plain,
                                             C.ATTN_TOL[torch.bfloat16])[0]
                rec["ms"][name] = C.cuda_ms(fn, repeats=repeats)
            qh, kh, vh = (t.view(b, l, h, -1).transpose(1, 2) for t in (q, k, v))
            rec["ms"]["SDPA"] = C.cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=amask, scale=1.0), repeats=repeats)
            rec["ms"]["plain"] = C.cuda_ms(
                lambda: AB.attention_core_int8_plain(q, k, v, b, h, **kw), iters=3)
            kernels = {n: rec["ms"][n] for n in AB.CORE_KERNELS}
            rec["fastest"] = min(kernels, key=kernels.get)
            out.append(rec)
            print(f"{'gated' if gated else 'ungated'} core {h}x{hd} {sec} s B={b} L={l}: "
                  + ", ".join(f"{n} {t:.4f}" for n, t in rec["ms"].items())
                  + f" ms; bound {rec['bound_ms']:.4f}; max |d| vs plain {rec['err']}; picks "
                  f"{rec['picked']}, fastest {rec['fastest']}", flush=True)
            del q, k, v, kw, amask, plain, qh, kh, vh
            torch.cuda.empty_cache()
    return out


def sass_counts():
    """Instructions of each compiled int8 core kernel at head dim 64, by
    opcode class, from ``cuobjdump -sass`` of the built library (a static
    count: every loop of onepass_wgmma_kernel is unrolled over its KT key
    tiles, so its consumer code runs once a block)."""
    import re

    so = _cuda._build_dir() / "libattention.so"
    tool = pathlib.Path(_cuda._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for block in text.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        if not re.search(r"onepass_(wgmma|mma|panel)_kernel.*Li64E", name):
            continue
        ops = collections.Counter()
        for line in block.splitlines():
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_]+)", line)
            if m:
                ops[m.group(2).split(".")[0]] += 1
        out[name] = dict(total=sum(ops.values()), **dict(ops.most_common(14)))
        print(f"SASS {name}: {out[name]}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--split", action="store_true",
                    help="time each launch of the sublayer's chain and list int8_linear's calls")
    ap.add_argument("--mha", action="store_true",
                    help="time each launch of the MHA sublayer's routes at the served call sites")
    ap.add_argument("--mha-routes", action="store_true",
                    help="sweep both routes of the MHA sublayer over a ladder of batches")
    ap.add_argument("--mha-model", action="store_true",
                    help="the readings behind the MHA route's estimate with the LayerNorm")
    ap.add_argument("--cores", action="store_true",
                    help="time the int8 core's kernels at every served WavLM length")
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
    if args.cores:
        out["cores"] = core_sweep(gen, args.repeats)
        out["sass"] = sass_counts()
    elif args.mha_model:
        out["mha_model"] = mha_model(gen, args.repeats)
    elif args.mha or args.mha_routes:
        if args.mha:
            out["mha_split"] = mha_split(gen, args.repeats)
            out["mha_core"] = mha_core_sweep(gen, args.repeats)
        if args.mha_routes:
            out["mha_routes"] = mha_route_sweep(gen, args.repeats)
    elif args.split:
        out["chain_split"] = chain_split(gen, args.repeats)
        out["int8_linear_shapes"] = linear_shapes()
    else:
        out.update(route_sweep(gen, args.repeats))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
