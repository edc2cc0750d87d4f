#!/usr/bin/env python3
"""Where the fused first FFN GEMM's time goes, by phase and block shape.

    python3 chip_ffn_int8_variants.py

Run from the repository root: it takes its timing from ``chip_smoke.py``.
Needs one NVIDIA GPU and ``nvcc``. Builds ``csrc/ffn_int8.cu`` as it is and
from copies of it in a temporary directory, none in the repository, with a
phase taken out:

- ``no epilogue``: the block returns after its products (no activation, no
  row maxima over the cluster, no quantize, no store);
- ``products only``: no x quantize either (the cluster barrier stays).

Each runs ``hr_ffn_gemm1`` (WavLM's 768 -> 3072, tanh GELU, bf16 x) at M =
1996 (the 10 s bucket at B=4) and 23,808 (the 1.25 s bucket at B=384) for
block configurations 0 (8 x 384) and 1 (12 x 256), CUDA-event ms of a CUDA
graph of 20 calls, beside the chain's first three launches (row quantize,
the shared GEMM with an fp32 h, row quantize of h). The build as it is is
first checked bit-equal to that chain. Prints the card's name and power
limit, each build's registers (ptxas) and a JSON line of every reading.
"""

from __future__ import annotations

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

EPILOGUE = "  cp_async_wait<0>();\n\n  // accumulator layout"
VARIANTS = {
    "as is": [],
    "no epilogue": [(EPILOGUE, "  cp_async_wait<0>();\n  if (K > 0) return;\n"
                               "  // accumulator layout")],
    "products only": [(EPILOGUE, "  cp_async_wait<0>();\n  if (K > 0) return;\n"
                                 "  // accumulator layout"),
                      ("const int nchunks = rows_in * row_chunks;", "const int nchunks = 0;")],
}
ROWS = (C.B * 499, 384 * 62)


def build(tmp: pathlib.Path) -> dict[str, ctypes.CDLL]:
    src = (_cuda.CSRC / "ffn_int8.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer has {old!r}")
            text = text.replace(old, new)
        d = tmp / name.replace(" ", "_")
        d.mkdir()
        (d / "ffn_int8.cu").write_text(text)
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(_cuda.CSRC),
               "-o", str(d / "lib.so"), str(d / "ffn_int8.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), d)
    libs = {}
    for name, (proc, d) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers", log)})
        print(f"{name}: registers {regs}", flush=True)
        lib = ctypes.CDLL(str(d / "lib.so"))
        lib.hr_ffn_gemm1.argtypes = _cuda.SIGNATURES["ffn_int8"]["hr_ffn_gemm1"]
        lib.hr_ffn_gemm1.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_ffn_int8_variants: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    gen = torch.Generator().manual_seed(C.SEED)
    mod = MLP2(768, 3072, 768)
    init_torch_defaults(mod, gen)
    p = C.quantized(mod).ops
    epi = _cuda.EPI_GELU_F32
    out = dict(card=smi, ms={})
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(pathlib.Path(tmp))
        for m in ROWS:
            x = torch.randn(m, 768, generator=gen).to("cuda", torch.bfloat16)
            hq, hs = _cuda.ffn_gemm1(x, p.w1, p.s1, p.b1, epi)
            xq, xs = _cuda.rowquant(x, div127=False)
            rq, rs = _cuda.rowquant(_cuda.int8_gemm(xq, xs, p.w1, p.s1, p.b1, epi), div127=False)
            if not (torch.equal(hq, rq) and torch.equal(hs, rs)):
                raise AssertionError(f"M={m}: the fused first GEMM differs from the chain")
            row = {"chain's first three launches": C.cuda_ms(lambda: _cuda.rowquant(
                _cuda.int8_gemm(*_cuda.rowquant(x, div127=False), p.w1, p.s1, p.b1, epi),
                div127=False))}
            for config in (0, 1):
                for name, lib in libs.items():
                    call = lambda lib=lib, config=config: _cuda.check(lib.hr_ffn_gemm1(
                        x.data_ptr(), 0, m, 768, p.w1.data_ptr(), p.s1.data_ptr(),
                        p.b1.data_ptr(), 3072, epi, config, hq.data_ptr(), hs.data_ptr(),
                        _cuda.stream()), name)
                    call()
                    row[f"{_cuda.FFN_CONFIGS[config][0]} columns, {name}"] = C.cuda_ms(call)
            out["ms"][m] = row
            print(f"M={m}: " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
