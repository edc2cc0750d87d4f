#!/usr/bin/env python3
"""Why the fp32 attention cores run 3xTF32, and split the way they do.

    python3 chip_tf32_terms.py

Needs one NVIDIA GPU and ``nvcc``. Builds ``csrc/wavlm_attention.cu`` and
``csrc/flash_attention.cu`` as they are (3xTF32: small.big + big.small +
big.big per product, big = x truncated to TF32, ``csrc/attention_tf32.cuh``)
and from two copies of the sources in a temporary directory, none in the
repository: ``1xTF32``, where ``mma_3xtf32`` keeps only big.big, one TF32
product; and ``3xTF32 cvt.rna``, where ``split_tf32`` rounds big and small
with ``cvt.rna.tf32.f32``. Each runs the fp32 gated, one-pass and streaming
cores at the paths' shapes on the same inputs, with q and k scaled so that
the scores reach about +-30 (scale 2.5) and unscaled (scale 1), against
the plain versions with TF32 off: max and median |error| under
``chip_smoke.py``'s ``ATTN_TOL[torch.float32]``, and CUDA-event ms. Prints
the card's name and power limit, each build's registers (ptxas), one line
per case, and a JSON line of every reading.
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

from chip_smoke import ATTN_TOL, compare, cuda_ms
from hriemo_torch.ops import _cuda
from hriemo_torch.ops import attention_block as AB
from hriemo_torch.ops import flash_attention as FA
from hriemo_torch.ops import wavlm_attention as WA

LIBS = ("wavlm_attention", "flash_attention")
# (old, new) in csrc/attention_tf32.cuh for each copy
COPIES = {
    "1xTF32": ("""  mma_tf32(c, as, bb0, bb1);
  mma_tf32(c, ab, bs0, bs1);
  mma_tf32(c, ab, bb0, bb1);""", "  mma_tf32(c, ab, bb0, bb1);"),
    "3xTF32 cvt.rna": ("""  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(__fsub_rn(x, __uint_as_float(big)));""",
                       """  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) : "f"(__fsub_rn(x, __uint_as_float(big))));"""),
}


def registers(log: str) -> dict:
    """attn_tf32_kernel<HD, GATED, STREAM, PAD> and attn_tf32_wide_kernel<HD,
    STREAM, PAD> -> ptxas's registers and spill bytes."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*(attn_tf32_\w*kernel)ILi(\d+)E((?:Lb\dE)+)",
                      line)
        if m:
            name = f"{m[1]}<{m[2]},{','.join(m[3][2::4])}>"
        elif name and "spill stores" in line:
            out[name] = line.split(",")[1].strip()
        elif name and "Used" in line:
            out[name] = f"{line.split('Used')[1].split(',')[0].strip()}, {out.get(name, '')}"
            name = None
    return out


def build_copy(tmp: pathlib.Path, edits) -> tuple[dict, dict]:
    """The two libraries from a copy of csrc with each ``(old, new)`` of
    ``edits`` replaced in attention_tf32.cuh; returns them and their
    registers."""
    src = tmp / "csrc"
    shutil.copytree(_cuda.CSRC, src)
    header = src / "attention_tf32.cuh"
    text = header.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError("attention_tf32.cuh: the replaced lines are not where they were")
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


def cases(gen, scale: float):
    """(name, kernel call, plain call, max |score|) at the fp32 paths' shapes."""
    dev = "cuda"

    def heads(b, l, h, hd, s=1.0):
        x = torch.randn(b, l, h * hd, generator=gen) * s
        return x.to(dev).view(b, l, h, hd).transpose(1, 2)

    def kbias(b, l):
        lens = torch.randint(l // 2, l + 1, (b,), generator=gen)
        lens[0] = l
        pad = torch.arange(l)[None, :] >= lens[:, None]
        return torch.where(pad, AB.NEG_INF, 0.0).float().to(dev)

    out = []
    b, l, h, hd = 2, 499, 12, 64
    q, k, v = heads(b, l, h, hd, scale), heads(b, l, h, hd, scale), heads(b, l, h, hd)
    gate = (torch.rand(b, h, l, generator=gen) * 1.5 + 0.5).to(dev)
    pos = (torch.randn(h, l, l, generator=gen) * 0.3).to(dev)
    kb = kbias(b, l)
    out.append((f"wavlm_fused_attention B={b} L={l} H={h} hd={hd}",
                lambda: WA.wavlm_fused_attention(q, k, v, gate, pos, kb),
                lambda: WA.wavlm_fused_attention_plain(q, k, v, gate, pos, kb),
                WA.scaled_scores(q, k).abs().max().item()))
    for name, l in (("onepass_attention", 1499), ("streaming_attention", 2249)):
        b, h, hd = 2, 8, 96
        q2, k2, v2 = heads(b, l, h, hd, scale), heads(b, l, h, hd, scale), heads(b, l, h, hd)
        kb2 = kbias(b, l)
        fn, plain = getattr(FA, name), getattr(FA, name + "_plain")
        out.append((f"{name} B={b} {l}x{l} H={h} hd={hd}",
                    lambda fn=fn, q=q2, k=k2, v=v2, kb=kb2: fn(q, k, v, kb),
                    lambda fn=plain, q=q2, k=k2, v=v2, kb=kb2: fn(q, k, v, kb),
                    WA.scaled_scores(q2, k2).abs().max().item()))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_tf32_terms: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions stay fp32
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _cuda.build_all()
    builds = {"3xTF32": {name: _cuda.lib(name) for name in LIBS}}
    regs = {"3xTF32": {}}
    for name in LIBS:
        regs["3xTF32"].update(registers((_cuda._build_dir() / f"lib{name}.log").read_text()))
    readings = []
    with tempfile.TemporaryDirectory(prefix="tf32_terms_") as tmp:
        for i, (copy, (old, new)) in enumerate(COPIES.items()):
            (pathlib.Path(tmp) / str(i)).mkdir()
            builds[copy], regs[copy] = build_copy(pathlib.Path(tmp) / str(i), [(old, new)])
        for copy, r in regs.items():
            print(f"  {copy}: registers, spills {r}", flush=True)
        gen = torch.Generator().manual_seed(0)
        for scale in (2.5, 1.0):
            for name, fn, plain, smax in cases(gen, scale):
                ref = plain()
                for copy, libs in builds.items():
                    _cuda._libs.update(libs)
                    got = fn()
                    torch.cuda.synchronize()
                    diff = (got - ref).abs()
                    med = diff.flatten(1).median(dim=1).values.max().item()
                    try:
                        compare(name, got, ref, ATTN_TOL[torch.float32])
                        held = True
                    except AssertionError:
                        held = False
                    ms = cuda_ms(fn)
                    readings.append(dict(case=name, q_k_scale=scale, max_abs_score=smax,
                                         build=copy, max_abs_err=diff.max().item(),
                                         median_abs_err_per_batch=med, attn_tol_fp32_held=held,
                                         ms=ms))
                    print(f"  {name:42s} scale {scale} (|s| <= {smax:.1f}) {copy:14s}: "
                          f"max|d| {diff.max().item():.3g}, median {med:.3g}, "
                          f"ATTN_TOL[fp32] {'held' if held else 'missed'}, {ms:.4f} ms",
                          flush=True)
                _cuda._libs.update(builds["3xTF32"])
    print(json.dumps({"card": smi, "registers": regs, "readings": readings}))
    bad = [r for r in readings if r["build"] == "3xTF32" and not r["attn_tol_fp32_held"]]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
