#!/usr/bin/env python3
"""Where the TMA route's first product's time goes, by phase.

    python3 chip_ffn_tma_variants.py

Run from the repository root: it takes its timing from ``chip_smoke.py``.
Needs one NVIDIA GPU and ``nvcc``. Builds ``csrc/ffn_tma.cu`` as it is and
from copies of it in a temporary directory, none in the repository, with
the parts that its ``// variant NAME {`` ... ``}`` comments mark replaced:

- ``no activation``: h = (acc * xs) * s1 + b1, no GELU (``act``);
- ``no exchange``: no row maxima over the cluster (``exchange``);
- ``no quantize or store``: h's codes neither computed nor stored (``store``);
- ``products only``: every part after the products (``tail``).

Each runs ``hr_ffn_tma_gemm1`` (WavLM's 768 -> 3072, bf16 x quantized by
``hr_ffn_tma_xquant``) at M = 3072 and 23,808, tanh and erf GELU, CUDA-event ms
of a CUDA graph of 20 calls; the build as it is is first checked bit-equal
to the chain's first three launches. Prints the card's name and power
limit, each build's registers and spills (ptxas), the as-is tanh kernel's
SASS instructions by opcode (its listing in
``chip_smoke_out/ffn_tma_gemm1_sass.txt``) and a JSON line of every reading.
"""

from __future__ import annotations

import collections
import ctypes
import json
import pathlib
import re
import subprocess
import sys
import tempfile

import torch

import chip_smoke as C
from hriemo_torch.nn.layers import MLP2, init_torch_defaults
from hriemo_torch.ops import _cuda

ACT = '''      const float h0 = epilogue<kEpiF32>(acc[4 * j], xs_lo, w2.x, b2.x, 0.f);
      const float h1 = epilogue<kEpiF32>(acc[4 * j + 1], xs_lo, w2.y, b2.y, 0.f);
      const float h2 = epilogue<kEpiF32>(acc[4 * j + 2], xs_hi, w2.x, b2.x, 0.f);
      const float h3 = epilogue<kEpiF32>(acc[4 * j + 3], xs_hi, w2.y, b2.y, 0.f);
'''
VARIANTS = {
    "as is": {},
    "no activation": {"act": ACT},
    "no exchange": {"exchange": ""},
    "no quantize or store": {"store": ""},
    "products only": {"tail": "    if (g.M > 0) continue;\n"},
}
ROWS = (3072, 384 * 62)
EPIS = {"tanh": _cuda.EPI_GELU_F32, "erf": _cuda.EPI_GELU_ERF_F32}


def variant(src: str, edits: dict) -> str:
    for name, new in edits.items():
        pat = re.compile(rf"( *// variant {name} {{\n)(.*?)( *// variant {name} }}\n)", re.S)
        if not pat.search(src):
            raise RuntimeError(f"csrc/ffn_tma.cu has no variant {name!r}")
        src = pat.sub(lambda m: m.group(1) + new + m.group(3), src)
    return src


def build(tmp: pathlib.Path) -> dict[str, ctypes.CDLL]:
    src = (_cuda.CSRC / "ffn_tma.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        d = tmp / name.replace(" ", "_")
        d.mkdir()
        (d / "ffn_tma.cu").write_text(variant(src, edits))
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(_cuda.CSRC),
               "-o", str(d / "lib.so"), str(d / "ffn_tma.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), d)
    libs = {}
    for name, (proc, d) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        regs = re.findall(r"(\d+) bytes spill stores.*\n.*Used (\d+) registers", log)
        print(f"{name}: (spill stores, registers) of its instances {regs}", flush=True)
        lib = ctypes.CDLL(str(d / "lib.so"))
        lib.hr_ffn_tma_gemm1.argtypes = _cuda.SIGNATURES["ffn_tma"]["hr_ffn_tma_gemm1"]
        lib.hr_ffn_tma_gemm1.restype = ctypes.c_int
        libs[name] = lib
        if name == "as is":
            sass_report(d / "lib.so")
    return libs


def sass_report(so: pathlib.Path) -> None:
    """The as-is tanh instance's SASS by opcode, and its listing."""
    cuobjdump = str(pathlib.Path(_cuda._nvcc()).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True, text=True).stdout
    mine = next((part for part in sass.split("Function : ")
                 if part.startswith("_ZN2hr20ffn_tma_gemm1_kernelILi192ELi1EEE")), "")
    C.OUT.mkdir(exist_ok=True)
    (C.OUT / "ffn_tma_gemm1_sass.txt").write_text(mine)
    ops = collections.Counter(m.group(1).split(".")[0] for m in
                              re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)",
                                          mine))
    print(f"SASS of ffn_tma_gemm1_kernel<192, tanh>: {sum(ops.values())} instructions, "
          f"{dict(ops.most_common(40))}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_ffn_tma_variants: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    gen = torch.Generator().manual_seed(C.SEED)
    mod = MLP2(768, 3072, 768)
    init_torch_defaults(mod, gen)
    p = C.quantized(mod).ops
    bn = _cuda.ffn_tma_block1(3072, 768)
    out = dict(card=smi, ms={})
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(pathlib.Path(tmp))
        for m in ROWS:
            x = torch.randn(m, 768, generator=gen).to("cuda", torch.bfloat16)
            xq, xs = _cuda.ffn_tma_xquant(x)
            row = {}
            for act, epi in EPIS.items():
                clusters = _cuda.ffn_tma_clusters(1, 3072, 768, epi, bn)
                hq, hs = _cuda.ffn_tma_gemm1(xq, xs, p.w1, p.s1, p.b1, epi)
                rq, rs = _cuda.rowquant(_cuda.int8_gemm(xq, xs, p.w1, p.s1, p.b1, epi),
                                        div127=False)
                if not (torch.equal(hq, rq) and torch.equal(hs, rs)):
                    raise AssertionError(f"M={m} {act}: the first product differs from the chain")
                for name, lib in libs.items():
                    call = lambda lib=lib, epi=epi, clusters=clusters: _cuda.check(
                        lib.hr_ffn_tma_gemm1(xq.data_ptr(), xs.data_ptr(), m, 768,
                                             _cuda.ffn_tma_wmap(p.w1, bn), p.s1.data_ptr(),
                                             p.b1.data_ptr(),
                                             3072, epi, bn, clusters, hq.data_ptr(),
                                             hs.data_ptr(), _cuda.stream()), name)
                    call()
                    row[f"{act}, {name}"] = C.cuda_ms(call)
            out["ms"][m] = row
            print(f"M={m}: " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
