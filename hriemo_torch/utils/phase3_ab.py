#!/usr/bin/env python3
"""Phase 3 of ``chip_smoke.py`` on several checkouts of the repository in
turn, on one card, to compare commits.

    python3 -m hriemo_torch.utils.phase3_ab DIR [DIR ...]

Each DIR holds a checkout, such as a commit unpacked by ``git archive`` into
a directory that ``.gitignore`` lists; give them in the order to run them,
e.g. parent, change, change, parent. Each runs in a process of its own, from
its directory: it builds that checkout's kernels and calls its
``chip_smoke.check_kernels`` (every kernel against its plain version, CUDA
events around a CUDA graph of 20 calls), and its rows go to
``chiprun_out/phase3_ab/<run>.json``. Prints the card's name and power
limit, the registers and spill bytes of each checkout's attention kernels
(ptxas), and one line per (kernel, shape) with its ms in every run. Needs
one NVIDIA GPU and ``nvcc``.
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
rows, _ = C.check_kernels(torch.Generator().manual_seed(C.SEED))
pathlib.Path(sys.argv[1]).write_text(json.dumps(rows, default=str))
"""
ATTENTION_LIBS = ("wavlm_attention", "flash_attention")


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
    trees = [pathlib.Path(d).resolve() for d in (argv or sys.argv[1:])]
    if not trees:
        print(__doc__)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
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
    for key in runs[0][1]:
        ms = [f"{rows[key]['ms']:.4f}" if key in rows else "-" for _, rows in runs]
        print(f"  {key[0]:22s} {key[1]:32s} {'  '.join(ms)}")
    print(json.dumps({name: {" ".join(k): r["ms"] for k, r in rows.items()}
                      for name, rows in runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
