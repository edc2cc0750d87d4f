#!/usr/bin/env python3
"""Where the conv stack's TMA GEMM spends its time: the kernel as it is
beside copies of it with one part taken out.

    python3 chip_conv_gemm_variants.py

Run from the repository root on a machine with one NVIDIA GPU and ``nvcc``;
it takes its timing from ``chip_smoke.py``. Builds ``csrc/conv_stack.cu`` as
it is and from copies of the sources in a temporary directory (none in the
repository), each with the parts of ``csrc/tma_gemm.cuh`` that its
``// variant NAME {`` ... ``}`` comments mark replaced (``COPIES``):

- ``direct stores``: each thread stores its GELU pairs (4 bytes) straight
  from its registers (tanh GELU only), with no staging tile and no TMA
  store;
- ``16-byte stores``: each warp stores its own 16 rows of the staging tile
  with 16-byte stores, 8 lanes a row, and no TMA store;
- ``no GELU``: the epilogue stores the sums rounded to bf16, without the
  IEEE tanh GELU;
- ``no epilogue``: no staging and no store at all;
- ``no products``: the consumers wait for each stage and free it, issuing
  no wgmma (the loads and the epilogue alone);
- ``no loads``: the producer arms each stage's barrier without a copy (the
  products on whatever the ring holds, and the epilogue).

Each runs ``conv_stack.conv_gemm`` with each column tile forced (128 and
256) at conv1 and conv2 of 1.25 s x 384 and 10 s x 32 and conv1 of 1 s x 1
(bf16, tanh GELU, random weights from a seed), on the same inputs: CUDA-event
ms (a CUDA graph of calls, ``chip_smoke.cuda_ms``) and the max |error|
against the plain version, which only the copies that keep the arithmetic
(as is and the two other stores) must hold to ``chip_smoke.CONV_TOL``. Prints the
card's name and power limit, each build's registers (ptxas), a line a
reading and a JSON line of every reading. Each build runs in a process of
its own, which puts it in ``_cuda``'s library slot that ``conv_gemm``
launches through.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

import torch

from chip_smoke import CONV_TOL, bound, compare, cuda_ms, nbytes
from hriemo_torch.ops import _cuda
from hriemo_torch.ops import conv_stack as CS

LIB = "conv_stack"
DIRECT = """        const int r0 = tl.m0 + wg * 64 + warp * 16 + g8, n0 = tl.n0 + 64 * c;
        T* const o = static_cast<T*>(g.f.out) + (size_t)tl.b * g.f.out_batch;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * (8 * c + jj) + 2 * h, m = r0 + 8 * h;
            if (m < g.f.M)
              store2(o + (size_t)m * g.f.ldo + n0 + 8 * jj + 2 * t4, gelu_tanh(acc[i]),
                     gelu_tanh(acc[i + 1]));
          }
"""
WIDE = """        uint8_t* const e = ebase + (c & 1) * kTgEpiBytes;
        __syncwarp();  // the warp's reads of its rows of e two passes ago are done
        if (g.f.fast)
          tg_gelu_pass<true>(acc, c, e, warp, g8, t4);
        else
          tg_gelu_pass<false>(acc, c, e, warp, g8, t4);
        __syncwarp();
        T* const o = static_cast<T*>(g.f.out) + (size_t)tl.b * g.f.out_batch;
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // row r (the warp's 16), 16-byte chunk ch
          const int r = 16 * warp + ((32 * q + lane) >> 3), ch = lane & 7;
          const int m = tl.m0 + 64 * wg + r;
          const uint4 v = *reinterpret_cast<const uint4*>(e + r * 128 + ((ch ^ (r & 7)) << 4));
          if (m < g.f.M)
            *reinterpret_cast<uint4*>(o + (size_t)m * g.f.ldo + tl.n0 + 64 * c + 8 * ch) = v;
        }
"""
# {marked part of csrc/tma_gemm.cuh: what replaces it} for each copy
COPIES = {
    "direct stores": {"pass": DIRECT},
    "16-byte stores": {"pass": WIDE},
    "no GELU": {"gelu": "          __floats2bfloat162_rn(acc[i], acc[i + 1]);\n"},
    "no epilogue": {"pass": ""},
    "no products": {"mma": "        (void)da, (void)db;\n"},
    "no loads": {"loads": "          mbar_arrive(full(st));\n"},
}
KEEPS_ARITHMETIC = ("as is", "direct stores", "16-byte stores")
# (bucket s, batch, conv): the served 1.25 s and 10 s pairs' first two convs, one 1 s clip
SHAPES = ((1.25, 384, 1), (1.25, 384, 2), (10.0, 32, 1), (10.0, 32, 2), (1.0, 1, 1))


def registers(log: str) -> dict:
    """tma_gemm_kernel<BN, EPI> -> ptxas's registers and spill bytes."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*tma_gemm_kernelILi(\d+)ELi(\d+)E", line)
        if m:
            name = f"BN {m.group(1)} epilogue {m.group(2)}"
        elif name and "spill stores" in line:
            out[name] = line.split(",")[1].strip()
        elif name and "Used" in line:
            out[name] = f"{line.split('Used')[1].split(',')[0].strip()}, {out.get(name, '')}"
            name = None
    return out


def build_copies(tmp: pathlib.Path) -> tuple[dict, dict]:
    """conv_stack's library from a copy of csrc for each of ``COPIES``, with
    its marked parts of tma_gemm.cuh replaced, all compiled at once; returns
    the libraries' paths and their registers by copy."""
    procs = {}
    for i, (copy, edits) in enumerate(COPIES.items()):
        src = tmp / str(i) / "csrc"
        shutil.copytree(_cuda.CSRC, src)
        header = src / "tma_gemm.cuh"
        text = header.read_text()
        for part, new in edits.items():
            marked = re.compile(rf"(// variant {part} {{\n).*?([ \t]*// variant {part} }})", re.S)
            text, n = marked.subn(lambda m, new=new: m.group(1) + new + m.group(2), text)
            if n != 1:
                raise RuntimeError(f"tma_gemm.cuh: {n} parts marked {part!r}, not one")
        header.write_text(text)
        so = tmp / str(i) / f"lib{LIB}.so"
        procs[copy] = (so, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(src), "-o", str(so),
             str(src / f"{LIB}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    paths, regs = {}, {}
    for copy, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the copy {copy!r} of {LIB}.cu:\n{log[-3000:]}")
        paths[copy], regs[copy] = so, registers(log)
    return paths, regs


def readings_of(copy: str, so: str) -> list:
    """Every shape on the library at ``so``, the build of conv_stack that
    this process puts in ``_cuda``'s library slot."""
    cdll = ctypes.CDLL(so)
    for fn, argtypes in _cuda.SIGNATURES[LIB].items():
        getattr(cdll, fn).argtypes = argtypes
        getattr(cdll, fn).restype = ctypes.c_int
    _cuda._libs[LIB] = cdll
    gen = torch.Generator().manual_seed(0)
    out = []
    for sec, b, conv in SHAPES:
        t_in = CS.conv_lengths(int(sec * 16000))[conv - 1]
        k = CS.KERNEL[conv]
        x = (torch.randn(b, t_in, CS.CHANNELS, generator=gen)).to("cuda", torch.bfloat16)
        w = (torch.randn(k, CS.CHANNELS, CS.CHANNELS, generator=gen)
             * (2.0 / (k * CS.CHANNELS)) ** 0.5).to("cuda", torch.bfloat16)
        ref = CS._conv_s2(x, w, True)
        m = ref.shape[1]
        b_ms, _ = bound(nbytes(x, w, ref), bf16_ops=2 * b * m * CS.CHANNELS ** 2 * k)
        iters = max(3, min(20, int(2e8 // (b * sec * 16000))))
        for bn in _cuda.TMA_BN:
            got = CS.conv_gemm(x, w, True, bn=bn)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            if copy in KEEPS_ARITHMETIC:
                compare(f"conv{conv} {copy} BN {bn}", got, ref, CONV_TOL[torch.bfloat16])
            ms = cuda_ms(lambda: CS.conv_gemm(x, w, True, bn=bn), iters=iters, repeats=3)
            out.append(dict(bucket_s=sec, b=b, conv=conv, m=m, bn=bn, build=copy, ms=ms,
                            bound_ms=b_ms, max_abs_err=err))
            print(f"  {sec:5g} s B={b:3d} conv{conv} M={m:6d} BN {bn} {copy:20s}: {ms:.4f} ms "
                  f"({b_ms / ms:.1%} of the {b_ms:.4f} ms bound), max|d| {err:.3g}", flush=True)
        del x, w, ref, got
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_conv_gemm_variants: no CUDA device is available", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--child"]:  # one build in this process: its readings as JSON
        print(json.dumps(readings_of(*sys.argv[2:4])))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _cuda.build_all()
    paths = {"as is": _cuda._build_dir() / f"lib{LIB}.so"}
    regs = {"as is": registers((_cuda._build_dir() / f"lib{LIB}.log").read_text())}
    readings = []
    with tempfile.TemporaryDirectory(prefix="conv_gemm_") as tmp:
        copies, copy_regs = build_copies(pathlib.Path(tmp))
        paths.update(copies)
        regs.update(copy_regs)
        for copy, r in regs.items():
            print(f"  {copy}: registers, spills {r}", flush=True)
        for copy, so in paths.items():
            proc = subprocess.run([sys.executable, __file__, "--child", copy, str(so)],
                                  stdout=subprocess.PIPE, text=True)
            lines = proc.stdout.strip().splitlines()
            print("\n".join(lines[:-1]), flush=True)
            if proc.returncode:
                print(f"  {copy}: exit {proc.returncode}", flush=True)
                return 1
            readings += json.loads(lines[-1])
    print(json.dumps({"card": smi, "registers": regs, "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
