#!/usr/bin/env python3
"""Why the float GEMM takes the pipeline and the sums it does.

    python3 -m hriemo_torch.utils.float_gemm_variants

Run from the repository root: it takes its tolerances and its timing from
``chip_smoke.py``. Needs one NVIDIA GPU and ``nvcc``. Builds
``csrc/ffn_bf16.cu`` and ``csrc/conv_stack.cu`` as they are (``csrc/float_wgmma.cuh``: 128 x 128
tiles; bf16 on ``wgmma`` from a 3-stage ring, two blocks an SM; fp32 in
3xTF32 from a 4-stage ring, one block an SM, each stage's partial sums
added to the block's sums in fp32) and from copies of the sources in a
temporary directory, none in the repository:

- ``bf16 one block an SM`` (a 5-stage ring) and ``bf16 one block, 7
  stages``;
- ``fp32 5 stages``: a deeper ring;
- ``fp32 unpromoted``: the three products of every stage accumulate in the
  tensor core's own sums over the whole K;
- ``fp32 1xTF32``: big.big only, one TF32 product.

Each runs ``ffn_block_bf16`` in fp32 at M = 3992 and 1996 (WavLM's 768 ->
3072 -> 768, tanh GELU; bf16 runs on ``csrc/tma_gemm.cuh``) and
``conv_stack_k1``'s convs at 8 x 10 s, bf16 and fp32, bf16 forced onto this
GEMM (``conv_stack._conv_launches`` with ``cp_async``), on the same inputs:
max and median |error| against the plain versions (TF32 off) under
``chip_smoke.py``'s tolerances (``FP32_TOL``, ``CONV_TOL``)
and CUDA-event ms, beside the FFN's cuBLAS + LayerNorm route; then, for the
build as it is, device ms by kernel from ``torch.profiler`` (the two GEMMs
and the LayerNorm; conv0 and the three conv GEMMs). Prints the card's name
and power limit, each build's registers (ptxas), one line per case, and a
JSON line of every reading.
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

from chip_smoke import CONV_TOL, EPS, FP32_TOL, compare, cuda_ms
from hriemo_torch.frontends import WavLMConfig, WavLMEncoder
from hriemo_torch.nn.layers import gelu, layer_norm
from hriemo_torch.ops import _cuda
from hriemo_torch.ops import conv_stack as CS
from hriemo_torch.ops import fused_ffn as FF

LIBS = ("ffn_bf16", "conv_stack")
# (old, new) in csrc/float_wgmma.cuh for each copy, and the dtype it changes
STAGES = "  static constexpr int STAGES = SPLIT ? 4 : 3, BLOCKS = SPLIT ? 1 : 2;"
COPIES = {
    "bf16 one block an SM": (torch.bfloat16, [
        (STAGES, "  static constexpr int STAGES = SPLIT ? 4 : 5, BLOCKS = 1;")]),
    "bf16 one block, 7 stages": (torch.bfloat16, [
        (STAGES, "  static constexpr int STAGES = SPLIT ? 4 : 7, BLOCKS = 1;")]),
    "fp32 5 stages": (torch.float32, [
        (STAGES, "  static constexpr int STAGES = SPLIT ? 5 : 3, BLOCKS = SPLIT ? 1 : 2;")]),
    "fp32 unpromoted": (torch.float32, [
        ("    float p[BN / 2];", "    float (&p)[BN / 2] = acc;"),
        ("        wgmma_tf32(p, dsa + 2 * kk, db + 2 * kk, kk);",
         "        wgmma_tf32(p, dsa + 2 * kk, db + 2 * kk, 1);"),
        ("      for (int i = 0; i < BN / 2; ++i) acc[i] = __fadd_rn(acc[i], p[i]);",
         "      for (int i = 0; i < 0; ++i) acc[i] = p[i];")]),
    "fp32 1xTF32": (torch.float32, [
        ("        wgmma_tf32(p, dsa + 2 * kk, db + 2 * kk, kk);\n"
         "        wgmma_tf32(p, da + 2 * kk, dsb + 2 * kk, 1);\n"
         "        wgmma_tf32(p, da + 2 * kk, db + 2 * kk, 1);",
         "        wgmma_tf32(p, da + 2 * kk, db + 2 * kk, kk);")]),
}


def registers(log: str) -> dict:
    """float_wgmma_kernel<T, EPI> -> ptxas's registers and spill bytes."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*float_wgmma_kernelI(\S+?)EEvNS", line)
        if m:
            name = m.group(1)
        elif name and "spill stores" in line:
            out[name] = line.split(",")[1].strip()
        elif name and "Used" in line:
            out[name] = f"{line.split('Used')[1].split(',')[0].strip()}, {out.get(name, '')}"
            name = None
    return out


def build_copy(tmp: pathlib.Path, edits) -> tuple[dict, dict]:
    """The two libraries from a copy of csrc with each (old, new) of ``edits``
    made in float_wgmma.cuh; returns them and their registers."""
    src = tmp / "csrc"
    shutil.copytree(_cuda.CSRC, src)
    header = src / "float_wgmma.cuh"
    text = header.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"float_wgmma.cuh: {old!r} is not where it was")
        text = text.replace(old, new)
    header.write_text(text)
    procs = {name: subprocess.Popen(
        [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(src), "-o",
         str(tmp / f"lib{name}.so"), str(src / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for name in LIBS}
    libs, regs = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for a copy of {name}.cu:\n{log[-3000:]}")
        regs.update(registers(log))
        cdll = ctypes.CDLL(str(tmp / f"lib{name}.so"))
        for fn, argtypes in _cuda.SIGNATURES[name].items():
            getattr(cdll, fn).argtypes = argtypes
            getattr(cdll, fn).restype = ctypes.c_int
        libs[name] = cdll
    return libs, regs


def cases(gen):
    """(name, dtype, kernel call, plain call, tolerance, route call or None)."""
    dev = "cuda"

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, dtype)

    out = []
    d, f = 768, 3072
    dt = torch.float32
    for m in (3992, 1996):
        w1, w2 = randn(f, d, scale=0.05, dtype=dt), randn(d, f, scale=0.05, dtype=dt)
        b1, b2, g, b = randn(f, scale=0.02), randn(d, scale=0.02), 1.0 + randn(d, scale=0.1), \
            randn(d, scale=0.1)
        x = randn(m, d, dtype=dt)
        ops = (x, w1, b1, w2, b2, g, b, 1e-5, True)
        out.append((f"ffn_block_bf16 M={m}", dt,
                    lambda ops=ops: FF.ffn_block_bf16(*ops),
                    lambda ops=ops: FF.ffn_block_bf16_plain(*ops),
                    FP32_TOL,
                    lambda x=x, w1=w1, w2=w2, b1=b1.to(dt), b2=b2.to(dt), g=g, b=b: layer_norm(
                        x + (gelu(x @ w1.t() + b1, True) @ w2.t() + b2), g, b, 1e-5)))
    enc = WavLMEncoder(WavLMConfig(num_hidden_layers=1))
    enc.init_weights(gen)
    enc = enc.to(dev).eval()
    for dt in (torch.bfloat16, torch.float32):
        w0, gn_w, gn_b, *taps = CS.stack_operands(enc.feature_extractor, dt)
        wave = randn(8, 160000, scale=0.3, dtype=dt)
        stats = CS.conv_stack_stats_plain(wave, w0)
        args = (wave, stats, w0, gn_w, gn_b, *taps[:3], EPS, False)
        out.append(("conv_stack_k1 B=8 Tw=160000", dt,
                    lambda a=args: CS._conv_launches(CS._conv0_launch(*a[:5], EPS, False), a[5:8],
                                                     False, cp_async=True),
                    lambda a=args: CS.conv_stack_k1_plain(*a), CONV_TOL[dt], None))
    return out


def by_kernel(fn, iters: int = 5) -> dict:
    """Device ms per call of ``fn`` by kernel name (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: round(e.self_device_time_total / 1e3 / iters, 4)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def main() -> int:
    if not torch.cuda.is_available():
        print("float_gemm_variants: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions stay fp32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _cuda.build_all()
    builds = {"as is": (None, {name: _cuda.lib(name) for name in LIBS})}
    regs = {"as is": {}}
    for name in LIBS:
        regs["as is"].update(registers((_cuda._build_dir() / f"lib{name}.log").read_text()))
    readings, profiles = [], []
    with tempfile.TemporaryDirectory(prefix="float_gemm_") as tmp:
        for i, (copy, (dt, edits)) in enumerate(COPIES.items()):
            (pathlib.Path(tmp) / str(i)).mkdir()
            libs, regs[copy] = build_copy(pathlib.Path(tmp) / str(i), edits)
            builds[copy] = (dt, libs)
        for copy, r in regs.items():
            print(f"  {copy}: registers, spills {r}", flush=True)
        for name, dt, fn, plain, tol, route in cases(torch.Generator().manual_seed(0)):
            ref = plain()
            route_ms = None if route is None else cuda_ms(route)
            for copy, (only, libs) in builds.items():
                if only not in (None, dt):
                    continue
                _cuda._libs.update(libs)
                got = fn()
                torch.cuda.synchronize()
                diff = (got.float() - ref.float()).abs()
                med = diff.flatten(1).median(dim=1).values.max().item()
                try:
                    compare(name, got, ref, tol)
                    held = True
                except AssertionError:
                    held = False
                ms = cuda_ms(fn)
                readings.append(dict(case=name, dtype=str(dt)[6:], build=copy,
                                     max_abs_err=diff.max().item(), median_abs_err=med,
                                     tol_held=held, ms=ms, route_ms=route_ms))
                print(f"  {name:28s} {str(dt)[6:]:8s} {copy:16s}: max|d| {diff.max().item():.3g}, "
                      f"median {med:.3g}, tolerance {'held' if held else 'missed'}, {ms:.4f} ms"
                      + ("" if route_ms is None else f" (route {route_ms:.4f} ms)"), flush=True)
            _cuda._libs.update(builds["as is"][1])
            profiles.append(dict(case=name, dtype=str(dt)[6:], device_ms=by_kernel(fn)))
            print(f"    as is, device ms by kernel: {profiles[-1]['device_ms']}", flush=True)
    print(json.dumps({"card": smi, "registers": regs, "readings": readings,
                      "profiles": profiles}))
    bad = [r for r in readings if r["build"] == "as is" and not r["tol_held"]]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
