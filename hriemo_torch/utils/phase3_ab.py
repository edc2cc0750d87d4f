#!/usr/bin/env python3
"""Phase 3 of ``chip_smoke.py`` on several checkouts of the repository in
turn, on one card, to compare commits.

    python3 -m hriemo_torch.utils.phase3_ab DIR [DIR ...]

Each DIR holds a checkout, such as a commit unpacked by ``git archive`` into
a directory that ``.gitignore`` lists; give them in the order to run them,
e.g. parent, change, change, parent. Each runs in a process of its own, from
its directory: it builds that checkout's kernels and calls its
``chip_smoke.check_kernels`` (every kernel against its plain version, CUDA
events around a CUDA graph of 20 calls), then times the int8 attention core
at ``CORE_SHAPES`` through that checkout's ``attention_core_int8`` (rows
marked ``(ab)``: the same inputs in every checkout, so a commit's kernels
stand beside another's at shapes that the older ``check_kernels`` lacks),
and its rows go to ``chiprun_out/phase3_ab/<run>.json``. Prints the card's
name and power limit, the registers and spill bytes of each checkout's
attention kernels (ptxas), and one line per (kernel, shape) with its ms in
every run. Needs one NVIDIA GPU and ``nvcc``.

    python3 -m hriemo_torch.utils.phase3_ab --repeat N DIR [DIR ...]

instead times only the flash-core rows of ``FLASH_ROWS`` in each checkout,
N CUDA-graph timings a row (the spread of one row across runs), and prints
each row's median and range by checkout.
"""

from __future__ import annotations

import json
import pathlib
import re
import subprocess
import sys

OUT = pathlib.Path("chiprun_out") / "phase3_ab"
RUN = """
import json, pathlib, sys, torch
import chip_smoke as C
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
C.OUT.mkdir(exist_ok=True)
from hriemo_torch.ops import attention_block as AB
rows, _ = C.check_kernels(torch.Generator().manual_seed(C.SEED))
g = torch.Generator().manual_seed(C.SEED + 14)
for d, h in %r:
    hd = d // h
    qkv = torch.randn(C.B * 499, 3 * d, generator=g).to("cuda", torch.bfloat16)
    qkv[:, :d] *= hd ** -0.5
    q, k, v = qkv.split(d, dim=1)
    lens = torch.randint(249, 500, (C.B,), generator=g)
    lens[0] = 499
    pad = (torch.arange(499)[None, :] >= lens[:, None]).cuda()
    fn = lambda: AB.attention_core_int8(q, k, v, C.B, h, kpm=pad)
    row = dict(kernel="attention_core_int8", shape=f"B={C.B} self 499x499 H={h} hd={hd} (ab)")
    try:
        row["max_abs_err"], _ = C.compare(f"int8 core {h}x{hd}", fn(),
                                          AB.attention_core_int8_plain(q, k, v, C.B, h, kpm=pad),
                                          C.ATTN_TOL[torch.bfloat16])
        row["ms"] = C.cuda_ms(fn)
    except RuntimeError as e:  # a launch the checkout's kernel refuses
        row["ms"], row["error"] = None, str(e)
    rows.append(row)
    print(rows[-1], flush=True)
pathlib.Path(sys.argv[1]).write_text(json.dumps(rows, default=str))
"""
# (d, heads) of the int8 core rows timed in every checkout: self 499^2 at B=4
CORE_SHAPES = ((256, 8), (768, 6), (768, 4), (768, 8), (768, 12))
RUN = RUN % (CORE_SHAPES,)
ATTENTION_LIBS = ("attention", "wavlm_attention", "flash_attention")
# (core, L, heads, head dim, dtype) of --repeat: phase 7d's lengths at B=16
FLASH_ROWS = (("onepass_attention", 1951, 8, 32, "bfloat16"),
              ("onepass_attention", 1951, 8, 32, "float16"),
              ("onepass_attention", 1951, 4, 64, "bfloat16"),
              ("streaming_attention", 2267, 8, 32, "bfloat16"),
              ("onepass_attention", 1951, 2, 128, "bfloat16"))
REPEAT = r"""
import json, sys, torch
import chip_smoke as C
from hriemo_torch.ops import flash_attention as FA
g = torch.Generator().manual_seed(5)
out = {}
for name, l, h, hd, dt in %r:
    dt = getattr(torch, dt)
    q, k, v = (torch.randn(16, l, h * hd, generator=g).to("cuda", dt).view(16, l, h, hd)
               .transpose(1, 2) for _ in range(3))
    lens = torch.randint(l // 2, l + 1, (16,), generator=g)
    lens[0] = l
    bias = FA.key_bias((torch.arange(l)[None] >= lens[:, None]).cuda(), 16, l, "cuda")
    fn = getattr(FA, name)
    out[f"{name} {h}x{hd} {str(dt)[6:]}"] = [C.cuda_ms(lambda: fn(q, k, v, bias))
                                              for _ in range(%d)]
print(json.dumps(out))
"""


def repeat(trees: list[pathlib.Path], n: int) -> int:
    """``--repeat n``: each checkout's ``FLASH_ROWS``, n timings a row."""
    import statistics

    by_tree = {}
    for i, tree in enumerate(trees):
        proc = subprocess.run([sys.executable, "-c", REPEAT % (FLASH_ROWS, n)], cwd=tree,
                              capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout[-2000:], proc.stderr[-3000:])
            return proc.returncode
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"run {i} {tree.name}: {got}", flush=True)
        for key, ms in got.items():
            by_tree.setdefault(tree.name, {}).setdefault(key, []).extend(ms)
    for key in next(iter(by_tree.values())):
        print(f"  {key}: " + " | ".join(
            f"{name} median {statistics.median(r[key]):.4f} "
            f"({min(r[key]):.4f}-{max(r[key]):.4f}, {len(r[key])} timings)"
            for name, r in by_tree.items()))
    return 0


def registers(tree: pathlib.Path) -> list[str]:
    """``kernel: registers, spill stores`` from the newest build's ptxas logs."""
    builds = sorted((tree / "hriemo_torch" / "_build").glob("*/libflash_attention.log"),
                    key=lambda p: p.stat().st_mtime)
    out, name = [], None
    for lib in ATTENTION_LIBS:
        for line in (builds[-1].parent / f"lib{lib}.log").read_text().splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name = m.group(1)
            elif name and "spill stores" in line:
                spill = line.split(",")[1].strip()
            elif name and "Used" in line:
                regs = line.split("Used")[1].split(",")[0].strip()
                out.append((lib, name, f"{regs}, {spill}"))
                name = None
    names = subprocess.run(["c++filt"], input="\n".join(n for _, n, _ in out),
                           capture_output=True, text=True).stdout.split("\n")
    return [f"{lib} {(names[i] or name)[:110]}: {used}"
            for i, (lib, name, used) in enumerate(out)]


def main(argv=None) -> int:
    args = list(argv or sys.argv[1:])
    n_repeat = 0
    if args[:1] == ["--repeat"]:
        n_repeat, args = int(args[1]), args[2:]
    trees = [pathlib.Path(d).resolve() for d in args]
    if not trees:
        print(__doc__)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    if n_repeat:
        return repeat(trees, n_repeat)
    runs = []
    for i, tree in enumerate(trees):
        path = OUT / f"{i}_{tree.name}.json"
        print(f"run {i}: {tree}", flush=True)
        with open(path.with_suffix(".log"), "w") as log:
            proc = subprocess.run([sys.executable, "-c", RUN, str(path.resolve())], cwd=tree,
                                  stdout=log, stderr=subprocess.STDOUT)
        if proc.returncode:
            print(path.with_suffix(".log").read_text()[-3000:])
            return proc.returncode
        runs.append((f"{i} {tree.name}",
                     {(r["kernel"], r["shape"]): r for r in json.loads(path.read_text())}))
    for tree in dict.fromkeys(trees):
        print(f"registers, {tree.name}:", *registers(tree), sep="\n  ", flush=True)
    print("ms by run: " + " | ".join(name for name, _ in runs))
    for key in dict.fromkeys(k for _, rows in runs for k in rows):
        ms = [f"{rows[key]['ms']:.4f}" if rows.get(key, {}).get("ms") is not None
              else rows[key].get("error", "-")[:40] if key in rows else "-" for _, rows in runs]
        print(f"  {key[0]:22s} {key[1]:32s} {'  '.join(ms)}")
    print(json.dumps({name: {" ".join(k): r.get("ms") for k, r in rows.items()}
                      for name, rows in runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
