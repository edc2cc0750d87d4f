#!/usr/bin/env python3
"""Where the W8A8 FFN pair's fused route beats its chain, by rows.

    python3 chip_ffn_routes.py [--repeats N]

Run from the repository root on a machine with one NVIDIA GPU and ``nvcc``;
it takes its timing from ``chip_smoke.py``. For each pair of widths a model
of the repo reaches (WavLM's and BERT's FFN, 768 -> 3072 -> 768, tanh and
erf GELU; the fusion FFNs at d=768 and d=256 and the beta gates at both,
ReLU) it runs ``ffn_block_int8`` / ``mlp2_int8`` on both routes
(``route="fused"`` and ``route="chain"``) over a ladder of rows, bf16 x (and
fp32 x for WavLM's FFN at three): each route's output bit-equal to the
other's, then CUDA-event ms of a CUDA graph of 20 calls, the median of N
replays (the chain alone where no cluster spans the widths: the beta gate
over 3072 inputs). Prints the card's name and power limit, a line a shape
with both times, the fused grid's waves over the card, the route that
``_cuda.ffn_route`` picks and whether it was the faster, and a JSON line of
every reading.
"""

from __future__ import annotations

import argparse
import json
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
EPI = {"tanh": _cuda.EPI_GELU_F32, "erf": _cuda.EPI_GELU_ERF_F32, "relu": _cuda.EPI_RELU_F32}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_ffn_routes: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    gen = torch.Generator().manual_seed(C.SEED + 21)
    sms = _cuda.sm_count()
    out = dict(card=smi, sms=sms, rows=[])
    for kernel, din, f, dout, act, rows, dtypes in SHAPES:
        mod = MLP2(din, f, dout)
        init_torch_defaults(mod, gen)
        pair = C.quantized(mod).ops
        if kernel == "ffn_block_int8":
            ops = FF.FfnOperands(pair, torch.rand(dout, generator=gen).add(0.5).cuda(),
                                 (0.1 * torch.randn(dout, generator=gen)).cuda())
            call = lambda x, route: FF.ffn_block_int8(x, ops, 1e-5, act == "tanh", route=route)
        else:
            call = lambda x, route: FF.mlp2_int8(x, pair, route=route)
        for dt in dtypes:
            for m in rows:
                x = torch.randn(m, din, generator=gen).to("cuda", dt)
                cl = _cuda.ffn_cluster(f, din)
                routes = ("chain",) if cl is None else ("fused", "chain")
                if cl is not None and not torch.equal(call(x, "fused"), call(x, "chain")):
                    raise AssertionError(f"{kernel} {din}->{f} {act} M={m} {dt}: the routes "
                                         "differ")
                ms = {r: C.cuda_ms(lambda r=r: call(x, r), repeats=args.repeats)
                      for r in routes}
                picked = _cuda.ffn_route(f, m, din, EPI[act], sms)
                rec = dict(kernel=kernel, widths=[din, f, dout], act=act, dtype=str(dt)[6:],
                           m=m, config=None, blocks=None, waves=None, fused_ms=ms.get("fused"),
                           chain_ms=ms["chain"], picked=picked,
                           picked_faster=ms[picked] <= min(ms.values()))
                if cl is None:
                    grid = "no cluster spans F"
                else:
                    rec.update(config=cl[0], blocks=cl[1], waves=-(-m // 64) * cl[1] / sms)
                    grid = (f"cluster {cl[1]:2d} x {_cuda.FFN_CONFIGS[cl[0]][0]:3d} waves "
                            f"{rec['waves']:7.3f}: fused {ms['fused']:.4f} ms (fused / chain "
                            f"{ms['fused'] / ms['chain']:.3f})")
                out["rows"].append(rec)
                print(f"{kernel:15s} {din:5d}->{f:5d}->{dout:4d} {act:4s} {rec['dtype']:8s} "
                      f"M={m:6d} {grid}; chain {ms['chain']:.4f} ms; picks {picked}"
                      f"{'' if rec['picked_faster'] else ' (the slower)'}", flush=True)
                del x
            torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
