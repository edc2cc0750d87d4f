"""Build and load the port's CUDA kernels (``hriemo_torch/csrc``).

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``. The
build runs at first use, one ``nvcc`` per source, all started together,
into ``hriemo_torch/_build/<hash of the sources and flags>/``, so a fresh
checkout builds everything on its first call and a rebuilt source never
loads a stale library. Nothing here runs when the module is imported.

Every C entry point returns ``cudaGetLastError()`` after its launches;
:func:`check` raises when that is not 0.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import math
import os
import pathlib
import subprocess
import threading
import time
import weakref

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parent.parent / "_build"
# No --use_fast_math: x / s must be an IEEE division and expf/tanhf must be
# the accurate versions, as in the plain PyTorch versions.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]
LIBS = ("quant_gemm", "ffn_tma", "proj_int8", "attention", "wavlm_attention",
        "attention_wgmma", "flash_attention", "streaming_wgmma", "ffn_bf16", "conv_stack")

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float
# C signatures, one per entry point (see the matching .cu file)
SIGNATURES = {
    "quant_gemm": {
        "hr_rowquant": [P, I, I, I, I, P, P, P],
        "hr_int8_gemm": [P, P, P, P, P, P, I, I, I, I, I, I, P, P],
        "hr_layernorm": [P, P, P, I, I, F, I, P, P],
    },
    "ffn_tma": {
        "hr_ffn_tma_xquant": [P, I, I, I, P, P, P],
        "hr_ffn_tma_wmap": [P, I, I, I, P],
        "hr_ffn_tma_gemm1": [P, P, I, I, P, P, P, I, I, I, I, P, P, P],
        "hr_ffn_tma_gemm1_clusters": [I, I, I, I],
        "hr_ffn_tma_gemm2": [P, P, I, I, P, P, P, I, P, P, P, F, I, I, I, I, P, P],
        "hr_ffn_tma_gemm2_clusters": [I, I, I, I, I],
    },
    "proj_int8": {
        "hr_proj_gemm": [P, I, I, I, P, P, P, I, I, I, I, P, P],
        "hr_proj_gemm_ln": [P, I, I, P, P, P, I, P, I, P, P, F, I, I, P, P],
        "hr_proj_gemm_clusters": [I, I, I, I],
    },
    "attention": {
        "hr_last_kernel": [],
        "hr_attention_core": [P, I, P, I, P, I, I, I, I, I, I, P, P,
                              P, I, I, P, P, P, P, P, I, I, P],
    },
    "wavlm_attention": {
        "hr_last_kernel": [],
        "hr_onepass_instance": [I, I, I],
        "hr_onepass_smem_bytes": [I, I, I, I, I],
        "hr_onepass_max_smem_bytes": [],
        "hr_onepass_attention": [I, P, I, I, I, P, I, I, I, P, I, I, I, I, I, I, I, I, F,
                                 P, P, P, P, I, I, I, I, P],
    },
    "attention_wgmma": {
        "hr_last_kernel": [],
        "hr_onepass_wgmma_instance": [I, I, I, I],
        "hr_onepass_wgmma_max_keys": [I],
        "hr_onepass_wgmma": [I, P, I, I, I, P, I, I, I, P, I, I, I, I, I, I, I, I, F,
                             P, P, P, P, I, I, I, I, P],
    },
    "flash_attention": {
        "hr_last_kernel": [],
        "hr_streaming_instance": [I, I],
        "hr_streaming_attention": [I, P, I, I, I, P, I, I, I, P, I, I, I, I, I, I, I, I, F,
                                   P, P, I, I, I, I, P],
    },
    "streaming_wgmma": {
        "hr_last_kernel": [],
        "hr_streaming_wgmma_instance": [I, I, I],
        "hr_streaming_wgmma": [I, P, I, I, I, P, I, I, I, P, I, I, I, I, I, I, I, I, F,
                               P, P, I, I, I, I, P],
    },
    "ffn_bf16": {
        "hr_ffn_gemms": [P, P, P, P, P, I, I, I, I, P, P, P],
        "hr_ffn_gemms_tma": [P, P, P, P, P, I, I, I, I, P, P, I, I, I, I, P],
    },
    "conv_stack": {
        "hr_conv_stats": [I, P, I, I, P, I, I, P, P, I, P],
        "hr_conv0_gn": [I, P, I, I, P, P, P, P, F, F, I, I, P, P],
        "hr_conv_s2": [I, P, L, I, I, P, I, I, I, P, P],
        "hr_conv_s2_tma": [P, I, I, I, P, I, I, I, I, P, P],
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(home) / "bin" / "nvcc"
    return str(path) if path.exists() else "nvcc"


def _build_dir() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict[str, float]:
    """Compile every library that is not built yet, all in parallel.
    Returns the wall seconds of each compile started here."""
    with _lock:
        out = _build_dir()
        out.mkdir(parents=True, exist_ok=True)
        procs = {}
        t0 = time.perf_counter()
        for name in LIBS:
            so = out / f"lib{name}.so"
            if so.exists():
                continue
            tmp = out / f"lib{name}.{os.getpid()}.tmp.so"
            cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC),
                   "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True),
                           tmp, so)
        errors, seconds = [], {}
        for name, (proc, tmp, so) in procs.items():
            log, _ = proc.communicate()
            seconds[name] = time.perf_counter() - t0
            (out / f"lib{name}.log").write_text(log)
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu:\n{log[-4000:]}")
            else:
                os.replace(tmp, so)
        if errors:
            raise RuntimeError("\n".join(errors))
        return seconds


def lib(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    if name in _libs:
        return _libs[name]
    so = _build_dir() / f"lib{name}.so"
    if not so.exists():
        build_all()
    with _lock:
        if name not in _libs:
            cdll = ctypes.CDLL(str(so))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(cdll, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = cdll
    return _libs[name]


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


# Activation dtypes of the int8 wrappers: their outputs, residuals and
# LayerNorms follow x's dtype, as the JAX wrappers store x.dtype.
ACT_DTYPES = (torch.bfloat16, torch.float32)


def require(t: torch.Tensor, name: str, dtype, shape=None,
            device: torch.device | None = None) -> None:
    """Checks a kernel operand: dtype (one, or a tuple of those taken),
    shape, contiguity, device and the 16-byte alignment the kernels' vector
    loads assume."""
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise TypeError(f"{name}: dtype {t.dtype}, kernel needs {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, kernel needs {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{name}: on {t.device}, kernel needs {device or 'cuda'}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer is not 16-byte aligned")


def heads_operand(t: torch.Tensor, name: str, dtype: torch.dtype, shape,
                  device: torch.device) -> list[int]:
    """A ``[B, H, L, hd]`` kernel operand read in place, such as a head view
    of a ``[B, L, H*hd]`` projection: ``[data pointer, batch stride, head
    stride, row stride]`` in elements. Each row must be contiguous and
    16-byte aligned (strides and the pointer a multiple of 8 elements)."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel needs {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, kernel needs {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, kernel needs {device}")
    if t.stride(-1) != 1 and t.shape[-1] > 1:
        raise ValueError(f"{name}: rows must be contiguous")
    strides = [s if n > 1 else 0 for s, n in zip(t.stride()[:3], t.shape[:3])]
    if t.data_ptr() % 16 or any(s % 8 for s in strides):
        raise ValueError(f"{name}: rows are not 16-byte aligned")
    return [t.data_ptr(), *strides]


# Element types of the float attention kernels' q/k/v/out, by the code the C
# entry points take (csrc/common.cuh DType)
DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}


# The attention kernels by the number that csrc/attention_tiles.cuh's
# LaunchedKernel gives them (0: none launched)
LAUNCHED_KERNELS = (None, "onepass_attn_kernel", "streaming_attn_kernel", "attn_core_kernel",
                    "onepass_mma_kernel", "onepass_wide_kernel", "streaming_mma_kernel",
                    "streaming_wide_kernel", "attn_tf32_kernel", "attn_tf32_wide_kernel",
                    "onepass_panel_kernel", "onepass_wgmma_kernel", "onepass_sweeps_kernel",
                    "streaming_wgmma_kernel")


def last_kernel(name: str) -> tuple[str | None, int]:
    """The attention kernel that library ``name`` launched last since this
    was last asked, by its name in the source, and its head dim (the tile
    instance's HD, or hd for a CUDA-core kernel); ``(None, 0)`` for none."""
    code = lib(name).hr_last_kernel()
    return LAUNCHED_KERNELS[code >> 16], code & 0xFFFF


def attention_operands(q, k, v, kbias, what: str):
    """Checks the operands of the float attention kernels (q ``[B, H, Lq,
    hd]``, k/v ``[B, H, Lk, hd]`` bf16, fp16 or fp32 read in place, kbias
    ``[B, Lk]`` fp32) and allocates the output. Returns the leading C
    arguments, ``(dtype code, q, k, v, B, H, Lq, Lk, hd, scale, kbias)`` with
    each of q/k/v as pointer and strides, and the output ``[B, H, Lq, hd]``,
    a head view of a contiguous ``[B, Lq, H*hd]`` tensor."""
    b, h, lq, hd = q.shape
    lk = k.shape[2]
    dev = q.device
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"{what}: dtype {q.dtype}, needs bf16, fp16 or fp32")
    if hd % 8 or hd > 256 or lk < 1:
        raise ValueError(f"{what}: head dim {hd} or key length {lk} not taken")
    args = [DTYPE_CODES[q.dtype]]
    for t, name, l in ((q, "q", lq), (k, "k", lk), (v, "v", lk)):
        args += heads_operand(t, name, q.dtype, (b, h, l, hd), dev)
    require(kbias, "key_padding_bias", torch.float32, (b, lk), dev)
    args += [b, h, lq, lk, hd, 1.0 / math.sqrt(hd), kbias.data_ptr()]
    out = torch.empty((b, lq, h, hd), dtype=q.dtype, device=dev)
    return args, out.transpose(1, 2)


# Epilogues of the shared int8 GEMM (csrc/int8_gemm.cuh)
(EPI_BF16, EPI_GELU_F32, EPI_RELU_F32, EPI_RESID_FIRST, EPI_RESID_LAST,
 EPI_GELU_ERF_F32, EPI_F32) = range(7)


def out_epi(dtype: torch.dtype) -> int:
    """The dequant-and-bias epilogue that stores ``dtype`` (bf16 or fp32)."""
    return EPI_F32 if dtype == torch.float32 else EPI_BF16


def rowquant(x: torch.Tensor, div127: bool):
    """Row-quantize a contiguous [M, K] fp32 or bf16 tensor on the card.
    ``div127`` picks ``max(amax,eps)/127`` (ops.quant.quantize_rowwise)
    over the kernels' ``max(amax,eps)*(1/127)``."""
    m, k = x.shape
    q = torch.empty((m, k), dtype=torch.int8, device=x.device)
    s = torch.empty((m,), dtype=torch.float32, device=x.device)
    check(lib("quant_gemm").hr_rowquant(
        x.data_ptr(), int(x.dtype == torch.bfloat16), m, k, int(div127),
        q.data_ptr(), s.data_ptr(), stream()), "hr_rowquant")
    rowquant.launches += 1
    return q, s


rowquant.launches = 0


# Block configurations of the int8 GEMM, by index (csrc/quant_gemm.cu)
GEMM_CONFIGS = ("64x64 s4", "64x64 s6 overlap", "128x128 s3")


def int8_gemm(a, a_scale, w, w_scale, bias, epi: int, resid=None,
              w_rows: tuple[int, int] | None = None, config: int = -1) -> torch.Tensor:
    """``epilogue(a [M,K] int8 . w[N,K]^T)``. ``w_rows=(r0, n)`` uses rows
    r0..r0+n of ``w``, ``w_scale`` and ``bias`` without a copy (the packed
    MHA in_proj). Output bf16 for EPI_BF16, else fp32; ``resid`` (the
    residual epilogues) is bf16 or fp32. ``config`` forces one
    of :data:`GEMM_CONFIGS` (-1: chosen by shape). Its plain version is
    ``ops.fused_ffn.int8_gemm_plain``. ``int8_gemm.launches`` counts its
    launches, ``int8_gemm.shapes`` the same by ``(M, N, K)``."""
    m, k = a.shape
    r0, n = w_rows if w_rows is not None else (0, w.shape[0])
    if k % 16:
        raise ValueError(f"int8 GEMM needs K % 16 == 0, got {k}")
    out = torch.empty((m, n), device=a.device,
                      dtype=torch.bfloat16 if epi == EPI_BF16 else torch.float32)
    check(lib("quant_gemm").hr_int8_gemm(
        a.data_ptr(), a_scale.data_ptr(), w.data_ptr() + r0 * k,
        w_scale.data_ptr() + 4 * r0,
        None if bias is None else bias.data_ptr() + 4 * r0,
        ptr(resid), int(resid is not None and resid.dtype == torch.float32), m, n, k, epi,
        config, out.data_ptr(), stream()), "hr_int8_gemm")
    int8_gemm.launches += 1
    int8_gemm.shapes[(m, n, k)] += 1
    return out


int8_gemm.launches = 0
int8_gemm.shapes = collections.Counter()


def layernorm(y: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float,
              dtype: torch.dtype = torch.bfloat16):
    """LayerNorm of fp32 rows ``y [M, N]``, fp32 statistics, stored as
    ``dtype`` (bf16 or fp32)."""
    m, n = y.shape
    out = torch.empty((m, n), dtype=dtype, device=y.device)
    check(lib("quant_gemm").hr_layernorm(
        y.data_ptr(), g.data_ptr(), b.data_ptr(), m, n, eps, int(dtype == torch.float32),
        out.data_ptr(), stream()), "hr_layernorm")
    layernorm.launches += 1
    return out


layernorm.launches = 0


# Block shapes of the projections that quantize their own rows
# (csrc/proj_int8.cu proj_config), by index: (output columns a block, most
# blocks a cluster, largest K). A cluster spans all N columns of 64 rows,
# above 8 blocks in a non-portable size; the 64 rows of int8 x (K bytes
# each) stay in each block's shared memory.
PROJ_CONFIGS = ((384, 8, 1280), (256, 16, 2816))
H100_SMS = 132


def sm_count() -> int:
    """SMs of the current card (``H100_SMS`` without one)."""
    if not torch.cuda.is_available():
        return H100_SMS
    if not hasattr(sm_count, "n"):
        sm_count.n = torch.cuda.get_device_properties(torch.cuda.current_device()) \
            .multi_processor_count
    return sm_count.n


# The bf16 GEMM on TMA and warpgroups (csrc/tma_gemm.cuh): rows of a tile,
# and its column-tile instances
TMA_BM = 128
TMA_BN = (256, 128)
# A 128-column tile's time over half a 256-column tile's, where each takes
# one wave: 1.05-1.17 on an NVIDIA H100 80GB HBM3 at 700 W (both instances
# at the served pairs and thin grids, chip_conv_routes.py --gemms, PERF.md
# section 6); at this cost every plan there read within 8% of the faster.
TMA_NARROW_COST = 1.1


def tma_gemm_plan(b: int, m: int, n: int, sms: int = H100_SMS,
                  bn: int | None = None) -> tuple[int, int]:
    """``(BN, blocks)`` of the persistent TMA GEMM over ``b`` batch elements
    of ``m`` rows and ``n`` columns on ``sms`` SMs: the 256-column tile,
    unless 128-column tiles finish sooner counting whole waves (a block's
    tiles, :data:`TMA_NARROW_COST` apiece against 2 for a 256-column tile),
    as on thin grids where the wide tiles leave SMs idle; ``bn`` forces one.
    One block an SM, at most one a tile."""
    row_tiles = b * -(-m // TMA_BM)
    tiles = {w: row_tiles * -(-n // w) for w in TMA_BN}
    if bn is None:
        waves = {w: -(-t // sms) for w, t in tiles.items()}
        bn = 128 if TMA_NARROW_COST * waves[128] < 2 * waves[256] else 256
    if bn not in tiles:
        raise ValueError(f"TMA GEMM: no {bn}-column instance (has {TMA_BN})")
    return bn, min(sms, tiles[bn])


def ffn_route(f: int, m: int, k: int, epi: int, sms: int = H100_SMS,
              n: int | None = None) -> str:
    """The FFN pair's route at ``m`` rows of ``k`` inputs, ``f`` hidden
    columns and ``n`` outputs (``k`` by default, as the FFN block has) with
    the first product's epilogue ``epi``: "tma" where :func:`ffn_tma_plan`
    takes the widths and the first product's row tiles cover the clusters
    the card runs at once :data:`TMA_MIN_WAVES` times, else "chain"."""
    n = k if n is None else n
    plan = ffn_tma_plan(f, k, n, ln=epi != EPI_RELU_F32)
    if plan is None:
        return "chain"
    waves = -(-m // 64) / ffn_tma_clusters(1, f, k, epi, plan[0], sms=sms)
    return "tma" if waves >= TMA_MIN_WAVES[epi == EPI_RELU_F32] else "chain"


# The FFN pair on TMA pipelines (csrc/ffn_tma.cu): columns a block of each
# product, widest first. The first product's cluster of f / bn blocks (a
# power of two up to 16) keeps each block's bn x k slice of W1 in shared
# memory beside a ring of at least two 8 KB x tiles; the second product's
# LayerNorm cluster spans n in n / 128 blocks (up to 8; with the LayerNorm a
# 192-column block spilled the values of y it holds, and was slower).
FFN_TMA_BN = (192, 128)
FFN_TMA_SMEM = 232448
# Waves of the first product's row tiles (64 rows) over the clusters the
# card runs at once, from which the TMA route beats the chain, for the GELU
# forms and for ReLU (chip_ffn_routes.py --split, NVIDIA H100 80GB HBM3 at 700 W,
# PERF.md section 6). A persistent cluster takes its row tiles one after
# another, so on a thin grid it pays its W1 load and its epilogues with few
# SMs busy: at 768 -> 3072 (16 blocks, 7 clusters) the tanh FFN over 256
# rows (0.6 waves) took 0.0354 ms against the chain's 0.0329, over 1,024
# (2.3) 0.0471 against 0.0520; the ReLU pair over 256 rows 0.0361 against
# 0.0294, over 1,024 0.0452 against 0.0489; the beta gate at d=256 (2
# blocks, 66 clusters) over 4,096 rows (0.97 waves) 0.0238 against 0.0301;
# the ReLU pair at 256 -> 1024 (8 blocks, 15 clusters) over 1,024 rows (1.07
# waves) 0.0207 against 0.0204, over 3,072 0.0280 against 0.0349.
TMA_MIN_WAVES = (2.0, 0.75)
# Clusters of each product that an NVIDIA H100 80GB HBM3 runs at once, by
# (product, blocks a cluster), for the route rule without a card
# (cudaOccupancyMaxActiveClusters, read by chip_smoke.py phase 3 and
# PERF.md section 6): a cluster sits in one GPC, so 16 blocks fit 7 times.
H100_FFN_TMA_CLUSTERS = {(1, 16): 7, (1, 8): 15, (1, 2): 66, (2, 6): 17, (2, 2): 66}


def _pow2(c: int) -> bool:
    return c >= 1 and c & (c - 1) == 0


def ffn_tma_smem1(bn: int, k: int, stages: int, cn: int) -> int:
    """Shared memory of the first product's block over a cluster of ``cn``
    blocks (csrc/ffn_tma.cu ``Ft1Layout``)."""
    return (-(-k // 128) * bn * 128 + stages * 64 * 128 + 2 * 64 * (bn + 16)
            + 2 * 2 * 64 * 4 + 2 * 2 * cn * 64 * 4 + (2 * 8 + 1 + 4) * 8 + 1024)


def ffn_tma_block1(f: int, k: int) -> int | None:
    """Columns a block of the TMA route's first product over ``k`` inputs
    and ``f`` hidden columns, or None (its W1 slice does not fit beside the
    ring: the beta gate's 3072 inputs)."""
    if k % 16:
        return None
    return next((b for b in FFN_TMA_BN if f % b == 0 and _pow2(f // b) and f // b <= 16
                 and ffn_tma_smem1(b, k, 2, f // b) <= FFN_TMA_SMEM), None)


def ffn_tma_block2(n: int, k: int, ln: bool) -> int | None:
    """Columns a block of the TMA route's second product over ``k`` inputs
    and ``n`` outputs, or None: with the LayerNorm (``ln``) 128, its cluster
    of ``n / 128`` blocks spanning ``n``; without, the widest of
    :data:`FFN_TMA_BN` that divides ``n``."""
    if k % 16:
        return None
    if ln:
        return 128 if n % 128 == 0 and n // 128 <= 8 else None
    return next((b for b in FFN_TMA_BN if n % b == 0), None)


def ffn_tma_plan(f: int, k: int, n: int, ln: bool = True) -> tuple[int, int] | None:
    """``(bn1, bn2)`` of the TMA route over ``k`` inputs, ``f`` hidden
    columns and ``n`` outputs (:func:`ffn_tma_block1`,
    :func:`ffn_tma_block2`), or None where either product takes no block."""
    bn1, bn2 = ffn_tma_block1(f, k), ffn_tma_block2(n, f, ln)
    return None if bn1 is None or bn2 is None else (bn1, bn2)


def ffn_tma_clusters(product: int, f: int, k: int, epi: int, bn: int, n: int | None = None,
                     x_f32: bool = False, ln: bool = True, sms: int = H100_SMS) -> int:
    """How many clusters of the TMA route's first (``product`` 1: ``f``
    columns over ``k`` inputs) or second product (2: ``n`` columns over
    ``f`` inputs) the card runs at once (``cudaOccupancyMaxActiveClusters``,
    read once a shape); without a card :data:`H100_FFN_TMA_CLUSTERS`, else
    one cluster for each cluster's worth of ``sms``."""
    cn = f // bn if product == 1 else (n // bn if ln else 1)
    if not torch.cuda.is_available():
        known = H100_FFN_TMA_CLUSTERS.get((product, cn)) if sms == H100_SMS else None
        return known or max(1, sms // cn)
    key = (product, f, k, epi, bn, n, x_f32, ln)
    if key not in ffn_tma_clusters.seen:
        tma = lib("ffn_tma")
        got = (tma.hr_ffn_tma_gemm1_clusters(k, f, epi, bn) if product == 1 else
               tma.hr_ffn_tma_gemm2_clusters(f, n, int(x_f32), int(ln), bn))
        check(-got if got < 0 else 0, f"hr_ffn_tma_gemm{product}_clusters")
        if got == 0:
            raise RuntimeError(f"FFN TMA product {product}: no cluster of {cn} blocks fits "
                               f"({torch.cuda.get_device_name()})")
        ffn_tma_clusters.seen[key] = got
    return ffn_tma_clusters.seen[key]


ffn_tma_clusters.seen = {}


def ffn_tma_wmap(w: torch.Tensor, bn: int) -> int:
    """Host address of the tensor map of an int8 weight ``w [rows, K]`` in
    boxes of ``bn`` rows for either TMA product (``hr_ffn_tma_wmap``),
    encoded once a weight tensor, address and block width and kept while the
    tensor lives (:data:`_WMAPS`), so a call encodes only the maps of its
    activations."""
    key = (id(w), w.data_ptr(), tuple(w.shape), bn)
    hit = _WMAPS.get(key)
    if hit is None or hit[0]() is not w:
        buf = (ctypes.c_uint8 * 128)()
        rows, k = w.shape
        check(lib("ffn_tma").hr_ffn_tma_wmap(w.data_ptr(), k, rows, bn, ctypes.addressof(buf)),
              "hr_ffn_tma_wmap")
        _WMAPS[key] = (weakref.ref(w, lambda _, key=key: _WMAPS.pop(key, None)), buf)
    return ctypes.addressof(_WMAPS[key][1])


# the encoded weight maps: (id, address, shape, bn) -> (weak reference, map)
_WMAPS: dict = {}


def ffn_tma_xquant(x: torch.Tensor):
    """x's row quantize for the TMA route (csrc/ffn_tma.cu, one warp a row):
    ``(q [M, K] int8, s [M] fp32)``, :func:`rowquant`'s bits with
    ``div127=False``. ``ffn_tma_xquant.launches`` counts launches."""
    require(x, "x", ACT_DTYPES)
    m, k = x.shape
    if k % 16:
        raise ValueError(f"FFN TMA x quantize needs K % 16 == 0, got {k}")
    q = torch.empty((m, k), dtype=torch.int8, device=x.device)
    s = torch.empty((m,), dtype=torch.float32, device=x.device)
    check(lib("ffn_tma").hr_ffn_tma_xquant(
        x.data_ptr(), int(x.dtype == torch.float32), m, k, q.data_ptr(), s.data_ptr(), stream()),
        "hr_ffn_tma_xquant")
    ffn_tma_xquant.launches += 1
    return q, s


ffn_tma_xquant.launches = 0


def ffn_tma_gemm1(xq: torch.Tensor, xs: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
                  bias: torch.Tensor, epi: int, bn: int | None = None, out=None):
    """``quant_rows(act(int8 W1 . xq * xs))`` on the TMA route's first
    product (csrc/ffn_tma.cu): ``xq [M, K]`` int8 and ``xs [M]`` from
    :func:`ffn_tma_xquant` (or :func:`rowquant`), w ``[F, K]`` int8,
    ``w_scale [F, 1]``, ``bias [F]``; ``epi`` is ``EPI_GELU_F32``,
    ``EPI_GELU_ERF_F32`` or ``EPI_RELU_F32``. Returns ``hq [M, F]`` int8 and
    ``hs [M]`` fp32, bit-equal to :func:`rowquant` of ``int8_gemm``'s fp32
    h. ``bn`` forces a block width; ``out=(hq, hs)`` stores into those
    tensors. ``ffn_tma_gemm1.launches`` counts launches."""
    m, k = xq.shape
    f = w.shape[0]
    bn = ffn_tma_block1(f, k) if bn is None else bn
    if bn is None:
        raise ValueError(f"FFN TMA first product: no block takes F={f} at K={k}")
    for t, name, dt, shape in ((xq, "xq", torch.int8, (m, k)), (xs, "xs", torch.float32, (m,)),
                               (w, "w1", torch.int8, (f, k)),
                               (w_scale, "s1", torch.float32, (f, 1)),
                               (bias, "b1", torch.float32, (f,))):
        require(t, name, dt, shape, xq.device)
    if out is None:
        out = (torch.empty((m, f), dtype=torch.int8, device=xq.device),
               torch.empty((m,), dtype=torch.float32, device=xq.device))
    hq, hs = out
    require(hq, "hq", torch.int8, (m, f), xq.device)
    require(hs, "hs", torch.float32, (m,), xq.device)
    clusters = ffn_tma_clusters(1, f, k, epi, bn)
    check(lib("ffn_tma").hr_ffn_tma_gemm1(
        xq.data_ptr(), xs.data_ptr(), m, k, ffn_tma_wmap(w, bn), w_scale.data_ptr(),
        bias.data_ptr(), f, epi, bn, clusters, hq.data_ptr(), hs.data_ptr(), stream()),
        "hr_ffn_tma_gemm1")
    ffn_tma_gemm1.launches += 1
    return hq, hs


ffn_tma_gemm1.launches = 0


def ffn_tma_gemm2(hq: torch.Tensor, hs: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
                  bias: torch.Tensor, out_dtype: torch.dtype, resid: torch.Tensor | None = None,
                  norm: tuple | None = None, bn: int | None = None,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """The TMA route's second product (csrc/ffn_tma.cu) over ``hq [M, K]``
    int8 and ``hs [M]``, w ``[N, K]`` int8, ``w_scale [N, 1]``, ``bias
    [N]``: with ``norm=(g, b, eps)`` and ``resid [M, N]`` of ``out_dtype``,
    ``LayerNorm((resid + v) + b)`` (:func:`int8_gemm`'s ``EPI_RESID_FIRST``
    value, then :func:`layernorm`'s formula with its sums in another
    order); without, :func:`int8_gemm`'s dequant-and-bias epilogue of
    ``out_dtype`` (bf16 or fp32), bit for bit. ``bn`` forces a block width;
    ``out`` stores into that tensor. ``ffn_tma_gemm2.launches`` counts
    launches."""
    m, k = hq.shape
    n = w.shape[0]
    ln = norm is not None
    if out_dtype not in ACT_DTYPES:
        raise TypeError(f"FFN TMA second product: output dtype {out_dtype}")
    bn = ffn_tma_block2(n, k, ln) if bn is None else bn
    if bn is None:
        raise ValueError(f"FFN TMA second product: no block takes N={n} (LayerNorm {ln})")
    for t, name, dt, shape in ((hq, "hq", torch.int8, (m, k)), (hs, "hs", torch.float32, (m,)),
                               (w, "w2", torch.int8, (n, k)),
                               (w_scale, "s2", torch.float32, (n, 1)),
                               (bias, "b2", torch.float32, (n,))):
        require(t, name, dt, shape, hq.device)
    g = b = None
    eps = 0.0
    if ln:
        g, b, eps = norm
        require(resid, "resid", out_dtype, (m, n), hq.device)
        require(g, "ln_w", torch.float32, (n,), hq.device)
        require(b, "ln_b", torch.float32, (n,), hq.device)
    if out is None:
        out = torch.empty((m, n), dtype=out_dtype, device=hq.device)
    require(out, "out", out_dtype, (m, n), hq.device)
    f32 = out_dtype == torch.float32
    clusters = ffn_tma_clusters(2, k, 0, 0, bn, n=n, x_f32=f32, ln=ln)
    check(lib("ffn_tma").hr_ffn_tma_gemm2(
        hq.data_ptr(), hs.data_ptr(), m, k, ffn_tma_wmap(w, bn), w_scale.data_ptr(),
        bias.data_ptr(), n,
        ptr(resid) if ln else None, ptr(g), ptr(b), eps, int(f32), int(ln), bn, clusters,
        out.data_ptr(), stream()), "hr_ffn_tma_gemm2")
    ffn_tma_gemm2.launches += 1
    return out


ffn_tma_gemm2.launches = 0


# The projections that quantize their own rows (csrc/proj_int8.cu) run on
# the blocks of PROJ_CONFIGS: a cluster spans all N output columns of 64 rows,
# and the block's 64 output rows are staged in its freed shared memory
# (64 x (BN + 8) elements of the output type over the A tiles and the ring).
PROJ_RING = ((3 * 384 * 128), (3 * 256 * 64))  # bytes of each block's W ring


def proj_cluster(n: int, k: int, out_bytes: int = 2,
                 config: int = -1) -> tuple[int, int] | None:
    """``(config, blocks a cluster)`` of a projection over ``k`` inputs and
    ``n`` output columns storing ``out_bytes`` an element: the widest block
    of :data:`PROJ_CONFIGS` that spans ``n`` at that ``k`` and holds its
    staged rows (``config`` forces one), or None."""
    for c, (bn, most, kmax) in enumerate(PROJ_CONFIGS):
        room = -(-k // 128) * 64 * 128 + PROJ_RING[c]
        if (n % bn == 0 and 1 <= n // bn <= most and k <= kmax and k % 16 == 0
                and 64 * (bn + 8) * out_bytes <= room and config in (-1, c)):
            return c, n // bn
    return None


# Waves of a projection's cluster grid (its blocks over the card's SMs) from
# which it beats the chain of a row quantize and the shared GEMM, by block
# configuration (chip_proj_routes.py, H100 80GB HBM3 at 700 W, PERF.md
# section 6). One launch of either block takes about 0.014-0.021 ms however
# few its rows (the quantize, the products and the epilogue of a block run
# in turn), where the chain's two launches take 0.008-0.013: 768 -> 768
# over 1,996 rows (0.48 waves of 2 x 384) 0.0167 against 0.0135 ms, over
# 3,072 (0.73 waves) 0.0172 against 0.0207; 768 -> 2048 over 1,536 rows
# (1.45 waves of 8 x 256) 0.0184 against 0.0208; 2048 -> 768 over 1,536
# (0.55 waves of 3 x 256) 0.0383 against 0.0228.
PROJ_MIN_WAVES = (0.6, 1.2)
# Waves of the 256-column block's grid from which it serves a width that the
# 384-column block spans too, at 2048 columns and more (the q/k/v
# projection: 0.0517 against 0.0574 ms at 4,096 rows, 4.4 waves; 0.0484
# against 0.0443 at 3,072, 3.3 waves)
PROJ_WIDE_MIN_WAVES = 4.0


def proj_block(n: int, m: int, k: int, out_bytes: int = 2,
               sms: int = H100_SMS) -> tuple[int, int] | None:
    """The projection's ``(config, blocks a cluster)`` at ``m`` rows: the
    256-column block where :func:`proj_cluster` would take the 384-column
    one at 2048 columns or more and the narrower block's grid covers the
    card :data:`PROJ_WIDE_MIN_WAVES` times, else :func:`proj_cluster`'s."""
    cl = proj_cluster(n, k, out_bytes)
    wide = proj_cluster(n, k, out_bytes, config=1)
    if (cl is not None and cl[0] == 0 and wide is not None and n >= 2048
            and -(-m // 64) * wide[1] / sms >= PROJ_WIDE_MIN_WAVES):
        return wide
    return cl


def proj_route(n: int, m: int, k: int, out_bytes: int = 2, sms: int = H100_SMS) -> str:
    """A projection's route at ``m`` rows: "fused" where a cluster spans
    ``n`` (:func:`proj_block`) and its grid covers the card
    :data:`PROJ_MIN_WAVES` times, else "chain"."""
    cl = proj_block(n, m, k, out_bytes, sms)
    if cl is None:
        return "chain"
    return "fused" if -(-m // 64) * cl[1] / sms >= PROJ_MIN_WAVES[cl[0]] else "chain"


# Clusters of a projection that an NVIDIA H100 80GB HBM3 runs at once, by
# (block configuration, blocks a cluster), at K = 768 (chip_proj_routes.py
# --mha-model): a cluster sits in one GPC, so fewer than SMs / blocks fit
# (4 blocks of 384 columns: 30, not 33).
H100_PROJ_CLUSTERS = {(0, 2): 66, (0, 4): 30, (0, 6): 17, (0, 8): 15,
                      (1, 3): 79, (1, 6): 39, (1, 9): 23, (1, 12): 16}


def proj_clusters(n: int, k: int, config: int, sms: int = H100_SMS) -> int:
    """How many clusters of :func:`proj_gemm` over ``k`` inputs and ``n``
    columns in block configuration ``config`` the card runs at once
    (``cudaOccupancyMaxActiveClusters``, read once a shape); without a card,
    :data:`H100_PROJ_CLUSTERS`, else one cluster for each cluster's worth of
    ``sms``."""
    blocks = n // PROJ_CONFIGS[config][0]
    if not torch.cuda.is_available():
        known = H100_PROJ_CLUSTERS.get((config, blocks)) if sms == H100_SMS else None
        return known or max(1, sms // blocks)
    key = (n, k, config)
    if key not in proj_clusters.seen:
        got = lib("proj_int8").hr_proj_gemm_clusters(64, k, n, config)
        check(-got if got < 0 else 0, "hr_proj_gemm_clusters")
        proj_clusters.seen[key] = max(1, got)
    return proj_clusters.seen[key]


proj_clusters.seen = {}


def proj_gemm(x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor, bias, epi: int,
              div127: bool, config: int = -1) -> torch.Tensor:
    """``epilogue<epi>(w . quant_rows(x))`` in one launch (csrc/proj_int8.cu):
    x ``[M, K]`` bf16 or fp32, w ``[N, K]`` int8, ``w_scale [N, 1]``, ``bias
    [N]`` or None; ``epi`` ``EPI_BF16`` (bf16 out) or ``EPI_F32`` (fp32 out:
    fp32 x with ``div127``, or bf16 x without); ``div127`` takes
    quantize_rowwise's scales over the kernels'. Bit-equal to :func:`rowquant` and :func:`int8_gemm`. ``config``
    forces one of :data:`PROJ_CONFIGS` (-1: :func:`proj_block`); raises where
    no cluster spans N. ``proj_gemm.launches`` counts launches."""
    m, k = x.shape
    n = w.shape[0]
    out_dtype = torch.bfloat16 if epi == EPI_BF16 else torch.float32
    cl = (proj_block(n, m, k, out_dtype.itemsize, sm_count()) if config == -1
          else proj_cluster(n, k, out_dtype.itemsize, config))
    if cl is None:
        raise ValueError(f"int8 projection: no cluster spans N={n} at K={k} (config {config})")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    check(lib("proj_int8").hr_proj_gemm(
        x.data_ptr(), int(x.dtype == torch.float32), m, k, w.data_ptr(), w_scale.data_ptr(),
        ptr(bias), n, epi, int(div127), cl[0], out.data_ptr(), stream()), "hr_proj_gemm")
    proj_gemm.launches += 1
    return out


proj_gemm.launches = 0


def proj_gemm_ln(a: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor, bias: torch.Tensor,
                 resid: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float,
                 config: int = -1, rounded: bool = False) -> torch.Tensor:
    """``LayerNorm(w . quant_rows(a) + bias + resid)`` in one launch
    (csrc/proj_int8.cu): a ``[M, K]`` bf16 (the attention context), resid
    ``[M, N]`` bf16 or fp32, output in resid's dtype; its y is
    :func:`int8_gemm`'s ``EPI_RESID_LAST`` bit for bit, its LayerNorm
    :func:`layernorm`'s formula with the sums in another order. ``rounded``:
    y is the projection stored in resid's dtype (:func:`out_epi`) plus resid
    in that dtype, bit for bit, as a caller that adds its residual to the
    stored output computes it. Raises where no cluster spans N.
    ``proj_gemm_ln.launches`` counts launches."""
    m, k = a.shape
    n = w.shape[0]
    cl = proj_cluster(n, k, resid.element_size(), config)
    if cl is None:
        raise ValueError(f"int8 projection: no cluster spans N={n} at K={k} (config {config})")
    out = torch.empty((m, n), dtype=resid.dtype, device=a.device)
    check(lib("proj_int8").hr_proj_gemm_ln(
        a.data_ptr(), m, k, w.data_ptr(), w_scale.data_ptr(), bias.data_ptr(), n,
        resid.data_ptr(), int(resid.dtype == torch.float32), g.data_ptr(), b.data_ptr(), eps,
        int(rounded), cl[0], out.data_ptr(), stream()), "hr_proj_gemm_ln")
    proj_gemm_ln.launches += 1
    return out


proj_gemm_ln.launches = 0
