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

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parent.parent / "_build"
# No --use_fast_math: x / s must be an IEEE division and expf/tanhf must be
# the accurate versions, as in the plain PyTorch versions.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]
LIBS = ("quant_gemm", "ffn_int8", "proj_int8", "attention", "wavlm_attention",
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
    "ffn_int8": {
        "hr_ffn_gemm1": [P, I, I, I, P, P, P, I, I, I, P, P, P],
        "hr_ffn_gemm1_clusters": [I, I, I, I, I, I],
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


# Block shapes of the fused first FFN GEMM (csrc/ffn_int8.cu requant_config),
# by index: (h columns a block, most blocks a cluster, largest K). A cluster
# spans all F columns of 64 rows, above 8 blocks in a non-portable size; the
# 64 rows of int8 x (K bytes each) stay in each block's shared memory.
FFN_CONFIGS = ((384, 8, 1280), (256, 16, 2816))
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


def ffn_cluster(f: int, k: int, config: int = -1) -> tuple[int, int] | None:
    """``(config, blocks a cluster)`` of the fused first GEMM over ``k``
    inputs and ``f`` hidden columns: the widest block of :data:`FFN_CONFIGS`
    that spans ``f`` at that ``k`` (``config`` forces one), or None."""
    for c, (bn, most, kmax) in enumerate(FFN_CONFIGS):
        if f % bn == 0 and 1 <= f // bn <= most and k <= kmax and config in (-1, c):
            return c, f // bn
    return None


# Waves of the fused first product (its blocks over the card's SMs) from
# which the fused route beats the chain, by block configuration, for the
# GELU forms and for ReLU (chip_ffn_routes.py, H100 80GB HBM3 at 700 W,
# PERF.md section 6): a block of 384 columns holds its SM alone, so on a
# thin grid nothing hides its epilogue, and the chain's smaller blocks win
# (tanh GELU at 768 -> 3072: 1.13x the chain's time at 1996 rows, 1.04x at
# 4096, 1.00x at 6144, 0.92x at 8192); two blocks of 256 an SM win from 3072
# rows at 1024 columns.
FUSED_MIN_WAVES = ((5.8, 1.9), (0.95, 0.95))


def ffn_route(f: int, m: int, k: int, epi: int, sms: int = H100_SMS) -> str:
    """The FFN pair's route at ``m`` rows of ``k`` inputs and ``f`` hidden
    columns with the first product's epilogue ``epi``: "fused" where a
    cluster spans ``f`` (:func:`ffn_cluster`) and its grid covers the card
    :data:`FUSED_MIN_WAVES` times, else "chain"."""
    cl = ffn_cluster(f, k)
    if cl is None:
        return "chain"
    waves = -(-m // 64) * cl[1] / sms
    return "fused" if waves >= FUSED_MIN_WAVES[cl[0]][epi == EPI_RELU_F32] else "chain"


def ffn_gemm1(x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor, bias: torch.Tensor,
              epi: int, config: int = -1):
    """``quant_rows(act(int8 W1 . quant_rows(x)))`` in one launch
    (csrc/ffn_int8.cu): x ``[M, K]`` bf16 or fp32, w ``[F, K]`` int8,
    ``w_scale [F, 1]``, ``bias [F]``; ``epi`` is ``EPI_GELU_F32``,
    ``EPI_GELU_ERF_F32`` or ``EPI_RELU_F32``. Returns ``hq [M, F]`` int8 and
    ``hs [M]`` fp32, bit-equal to :func:`rowquant` of ``int8_gemm``'s fp32 h.
    ``config`` forces one of :data:`FFN_CONFIGS` (-1: :func:`ffn_cluster`);
    raises where no cluster spans F. ``ffn_gemm1.launches`` counts launches."""
    require(x, "x", ACT_DTYPES)
    m, k = x.shape
    f = w.shape[0]
    cl = ffn_cluster(f, k, config)
    if cl is None or k % 16:
        raise ValueError(f"fused FFN GEMM: no cluster spans F={f} at K={k} (config "
                         f"{config}), or K % 16")
    hq = torch.empty((m, f), dtype=torch.int8, device=x.device)
    hs = torch.empty((m,), dtype=torch.float32, device=x.device)
    check(lib("ffn_int8").hr_ffn_gemm1(
        x.data_ptr(), int(x.dtype == torch.float32), m, k, w.data_ptr(), w_scale.data_ptr(),
        bias.data_ptr(), f, epi, cl[0], hq.data_ptr(), hs.data_ptr(), stream()),
        "hr_ffn_gemm1")
    ffn_gemm1.launches += 1
    return hq, hs


ffn_gemm1.launches = 0


def ffn_gemm1_clusters(f: int, m: int, k: int, epi: int, x_f32: bool = False,
                       config: int = -1) -> int:
    """How many clusters of :func:`ffn_gemm1`'s instance the card runs at
    once (``cudaOccupancyMaxActiveClusters``)."""
    cl = ffn_cluster(f, k, config)
    if cl is None:
        raise ValueError(f"fused FFN GEMM: no cluster spans F={f} at K={k}")
    n = lib("ffn_int8").hr_ffn_gemm1_clusters(int(x_f32), m, k, f, epi, cl[0])
    check(-n if n < 0 else 0, "hr_ffn_gemm1_clusters")
    return n


# The projections that quantize their own rows (csrc/proj_int8.cu) run on
# the blocks of FFN_CONFIGS: a cluster spans all N output columns of 64 rows,
# and the block's 64 output rows are staged in its freed shared memory
# (64 x (BN + 8) elements of the output type over the A tiles and the ring).
PROJ_RING = ((3 * 384 * 128), (3 * 256 * 64))  # bytes of each block's W ring


def proj_cluster(n: int, k: int, out_bytes: int = 2,
                 config: int = -1) -> tuple[int, int] | None:
    """``(config, blocks a cluster)`` of a projection over ``k`` inputs and
    ``n`` output columns storing ``out_bytes`` an element: the widest block
    of :data:`FFN_CONFIGS` that spans ``n`` at that ``k`` and holds its
    staged rows (``config`` forces one), or None."""
    for c, (bn, most, kmax) in enumerate(FFN_CONFIGS):
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
    blocks = n // FFN_CONFIGS[config][0]
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
    forces one of :data:`FFN_CONFIGS` (-1: :func:`proj_block`); raises where
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
