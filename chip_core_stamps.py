#!/usr/bin/env python3
"""Where a block of the wgmma attention core spends its cycles.

    python3 chip_core_stamps.py

Run from the repository root on a machine with one NVIDIA GPU and ``nvcc``.
It copies ``hriemo_torch/csrc`` into a temporary directory, inserts
``clock64()`` stamps at the phases of ``onepass_wgmma_kernel``
(``csrc/onepass_wgmma.cuh``), builds that copy's ``attention.cu`` with the
port's nvcc flags and runs it through ``hr_attention_core`` at served shapes:
WavLM's gated core (12 x 64) at B=32 L=499, B=64 L=249 and B=1 L=499, and
the fusion stack's ungated one (8 x 96) at B=32 L=499. Lane 0 of every warp
of the blocks of batch element 0 and head 0 writes its stamps through the
int8 route's unused gate-array pointer; the script prints, for the first and
the last query tile, the cycles from the block's first stamp: the producer
warp (all loads issued, its copies done, V issued) and both consumer
warpgroups' first warps (the gate computed, Q, the first K tile and pos
in, phase 1 done, the maxima exchanged, the exps done, the sums
exchanged, PV done, the end). The repository's sources are not touched.
"""

from __future__ import annotations

import ctypes
import pathlib
import shutil
import subprocess
import sys
import tempfile

import torch

from hriemo_torch.ops import _cuda

# (stamp slot, the line of csrc/onepass_wgmma.cuh it goes before): producer,
# then consumers
PRODUCER = ((0, "  if (tid == 0) {\n    mbar_init(qfull, 1);"),
            (1, "    // the padding mask's bytes, read now"),
            (2, "    if (VS >= kWgKTiles && lane < nt) {  // V by TMA"),
            (3, "    cp_async_wait_all();\n    return;"))
CONSUMER = ((1, "  // 1. the scores of this consumer"),
            (2, "#pragma unroll\n  for (int k = 0; k < KT; ++k) {\n    const int j = c + 2 * k;\n"
                "    if (k + 1 < KT) {"),
            (3, "  mx[0] = quad_max(mx[0]);"),
            (4, "  // 2. one exp a score"),
            (5, "  sum[0] = quad_sum(sum[0]);"),
            (6, "  // 3. p / l rounded"),
            (7, "  // 4. each consumer hands"))
END = "    for (int n = 0; n < NH; ++n) store(NH + n, ox[(NH + n) * 128 + ltid], tile(NH + n));\n  }\n"
PRODUCER_NAMES = ("start", "loads issued", "copies done", "V issued")
CONSUMER_NAMES = ("start", "gate", "Q, K and pos in", "phase 1 done", "maxima exchanged",
                  "exps done", "sums exchanged", "PV done", "end")
SHAPES = ((True, 64, 32, 499), (False, 96, 32, 499), (True, 64, 64, 249), (True, 64, 1, 499))
WARPS, SLOTS = 9, 10


def stamp(slot: int) -> str:
    return ("  if ((threadIdx.x & 31) == 0 && blockIdx.x == 0 && blockIdx.z == 0) "
            f"((long long*)a.gate)[(blockIdx.y * {WARPS} + (threadIdx.x >> 5)) * {SLOTS} "
            f"+ {slot}] = clock64();\n")


def instrumented(csrc: pathlib.Path, out: pathlib.Path) -> pathlib.Path:
    """A copy of ``csrc`` with the stamps in and the debug pointer passed;
    returns the built library."""
    shutil.copytree(csrc, out)
    hdr = out / "onepass_wgmma.cuh"
    text = hdr.read_text()
    for slot, anchor in PRODUCER + CONSUMER:
        if anchor not in text:
            raise RuntimeError(f"csrc/onepass_wgmma.cuh has no line {anchor!r}")
        text = text.replace(anchor, stamp(slot) + anchor, 1)
    if END not in text:
        raise RuntimeError("csrc/onepass_wgmma.cuh: the kernel's last store moved")
    text = text.replace(END, END + stamp(8), 1)
    hdr.write_text(text)
    cu = out / "attention.cu"
    src = cu.read_text()
    anchor = "    a.pos = static_cast<const bf*>(pos), a.out = static_cast<bf*>(ctx);\n"
    src = src.replace(anchor, anchor + "    a.gate = static_cast<const float*>(g_stamps);\n")
    src = src.replace('extern "C" {\n', 'static void* g_stamps = nullptr;\nextern "C" {\n'
                      'int hr_set_stamps(void* p) { g_stamps = p; return 0; }\n', 1)
    cu.write_text(src)
    so = out / "libattention_stamps.so"
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(out), "-o", str(so), str(cu)],
                   check=True, capture_output=True, text=True)
    return so


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_core_stamps: no CUDA device is available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory(prefix="core_stamps_") as tmp:
        lib = ctypes.CDLL(str(instrumented(_cuda.CSRC, pathlib.Path(tmp) / "csrc")))
        fn = lib.hr_attention_core
        fn.argtypes, fn.restype = _cuda.SIGNATURES["attention"]["hr_attention_core"], ctypes.c_int
        lib.hr_set_stamps.argtypes = [ctypes.c_void_p]
        gen = torch.Generator().manual_seed(0)
        rnd = lambda *shape, scale=1.0, dt=torch.bfloat16: (
            torch.randn(*shape, generator=gen) * scale).to("cuda", dt)
        for gated, hd, b, l in SHAPES:
            d, h = 768, 768 // hd
            qkv = rnd(b * l, 3 * d)
            qkv[:, :d] *= hd ** -0.5
            q, k, v = qkv.split(d, dim=1)
            stamps = torch.zeros(64 * WARPS * SLOTS, dtype=torch.int64, device="cuda")
            ctx = torch.empty(b * l, d, dtype=torch.bfloat16, device="cuda")
            keep = [rnd(b, l, dt=torch.float32) * 0, rnd(b * l, d, scale=0.3),
                    rnd(8, hd, scale=0.1, dt=torch.float32), rnd(8, scale=0.1, dt=torch.float32),
                    rnd(h, dt=torch.float32), rnd(h, l, l, scale=0.3)]
            kb, x, wg, bg, gc, pos = keep
            args = [q.data_ptr(), q.stride(0), k.data_ptr(), k.stride(0), v.data_ptr(),
                    v.stride(0), b, l, l, h, hd, kb.data_ptr() if gated else None, None]
            args += ([x.data_ptr(), d, 0, wg.data_ptr(), bg.data_ptr(), gc.data_ptr(),
                      pos.data_ptr()] if gated else [None, 0, 0, None, None, None, None])
            lib.hr_set_stamps(stamps.data_ptr())
            for _ in range(3):  # the last of three calls, past the first's start-up
                _cuda.check(fn(*args, ctx.data_ptr(), d, 2, _cuda.stream()), "hr_attention_core")
            torch.cuda.synchronize()
            t = stamps.view(64, WARPS, SLOTS).cpu()
            print(f"{'gated' if gated else 'ungated'} {h} x {hd} B={b} L={l}: clock64 cycles "
                  "from the producer's first stamp", flush=True)
            for qt in (0, (l + 63) // 64 - 1):
                base = t[qt, 8, 0].item()
                for w, names in ((8, PRODUCER_NAMES), (0, CONSUMER_NAMES), (4, CONSUMER_NAMES)):
                    who = "producer" if w == 8 else f"consumer {w // 4}"
                    print(f"  query tile {qt} {who}: " + ", ".join(
                        f"{n} {t[qt, w, i].item() - base}" for i, n in enumerate(names)),
                        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
