#!/usr/bin/env python3
"""Why the wide fp32 attention cores take 32-key tiles, one block an SM.

    python3 chip_tf32_wide_variants.py

Run from the repository root: it takes its tolerance and its timing from
``chip_smoke.py`` and its copy builder from ``chip_tf32_terms.py``. Needs
one NVIDIA GPU and ``nvcc``. Builds ``csrc/wavlm_attention.cu`` and
``csrc/flash_attention.cu`` as they are (``attn_tf32_wide_kernel`` of
``csrc/attention_tf32.cuh``: 32-key tiles, 156 KB of shared memory at HD
192 and 204 KB at 256, one block of 8 warps an SM) and from copies of the
sources in a temporary directory, none in the repository:

- ``16-key tiles``: ``kTf32WideBK = 16`` (104 KB at HD 192, 136 KB at 256),
  still one block an SM by its launch bounds;
- ``16-key tiles, two blocks at HD 192``: the same, with the launch bounds
  asking for two blocks an SM at HD 192 (128 registers a thread), where
  shared memory lets two blocks share an SM.

Each runs the fp32 one-pass and streaming cores at ``chip_smoke.py`` phase
3's wide fp32 shapes (B=2 1499² and 2249², 4 heads of 192; B=16 1951² and
2267², one head of 256; keys masked at random lengths) on the same inputs,
builds in turns (as they are, the copies, the copies in reverse, as they
are), three CUDA-graph timings a turn: max |error| against the plain
version under ``ATTN_TOL[torch.float32]`` and the median ms of each build.
Prints the card's name and power limit, each build's registers (ptxas),
one line per shape, and a JSON line of every reading.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import tempfile

import torch

from chip_smoke import ATTN_TOL, compare, cuda_ms
from chip_tf32_terms import LIBS, build_copy, registers
from hriemo_torch.ops import _cuda
from hriemo_torch.ops import flash_attention as FA

BK = "constexpr int kTf32WideBK = 32;"
BOUNDS = "__launch_bounds__(kWideThreads, 1) attn_tf32_wide_kernel"
COPIES = {
    "16-key tiles": [(BK, "constexpr int kTf32WideBK = 16;")],
    "16-key tiles, two blocks at HD 192": [
        (BK, "constexpr int kTf32WideBK = 16;"),
        (BOUNDS, "__launch_bounds__(kWideThreads, HD == 192 ? 2 : 1) attn_tf32_wide_kernel")],
}
# (core, batch, length, heads, head dim): chip_smoke.py phase 3's wide fp32 rows
SHAPES = (("onepass_attention", 2, 1499, 4, 192), ("onepass_attention", 16, 1951, 1, 256),
          ("streaming_attention", 2, 2249, 4, 192), ("streaming_attention", 16, 2267, 1, 256))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_tf32_wide_variants: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions stay fp32
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _cuda.build_all()
    builds = {"as is": {name: _cuda.lib(name) for name in LIBS}}
    regs = {"as is": {}}
    for name in LIBS:
        regs["as is"].update(registers((_cuda._build_dir() / f"lib{name}.log").read_text()))
    readings = []
    with tempfile.TemporaryDirectory(prefix="tf32_wide_") as tmp:
        for i, (copy, edits) in enumerate(COPIES.items()):
            (pathlib.Path(tmp) / str(i)).mkdir()
            builds[copy], regs[copy] = build_copy(pathlib.Path(tmp) / str(i), edits)
        for copy, r in regs.items():
            wide = {k: v for k, v in r.items() if "wide" in k}
            print(f"  {copy}: registers, spills {wide}", flush=True)
        order = list(builds) + list(builds)[:0:-1] + ["as is"]
        gen = torch.Generator().manual_seed(0)
        for name, b, l, h, hd in SHAPES:
            q, k, v = (torch.randn(b, l, h * hd, generator=gen).cuda().view(b, l, h, hd)
                       .transpose(1, 2) for _ in range(3))
            lens = torch.randint(l // 2, l + 1, (b,), generator=gen)
            lens[0] = l
            bias = FA.key_bias((torch.arange(l)[None] >= lens[:, None]).cuda(), b, l, "cuda")
            fn, plain = getattr(FA, name), getattr(FA, name + "_plain")
            ref = plain(q, k, v, bias)
            shape = f"{name} B={b} {l}x{l} H={h} hd={hd}"
            ms = {copy: [] for copy in builds}
            errs = {}
            for copy in order:
                _cuda._libs.update(builds[copy])
                if copy not in errs:
                    errs[copy], _ = compare(f"{shape} {copy}", fn(q, k, v, bias), ref,
                                            ATTN_TOL[torch.float32])
                ms[copy] += [cuda_ms(lambda: fn(q, k, v, bias)) for _ in range(3)]
            _cuda._libs.update(builds["as is"])
            for copy in builds:
                readings.append(dict(shape=shape, build=copy, max_abs_err=errs[copy],
                                     ms=ms[copy], median_ms=statistics.median(ms[copy])))
            print(f"  {shape}: " + " | ".join(
                f"{copy} {statistics.median(ms[copy]):.4f} ms ({min(ms[copy]):.4f}-"
                f"{max(ms[copy]):.4f}), max|d| {errs[copy]:.3g}" for copy in builds), flush=True)
            del q, k, v, ref
    print(json.dumps({"card": smi, "registers": regs, "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
