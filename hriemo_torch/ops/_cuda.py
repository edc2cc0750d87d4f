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
LIBS = ("quant_gemm", "attention", "wavlm_attention", "flash_attention", "ffn_bf16",
        "conv_stack")

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
    "attention": {
        "hr_last_kernel": [],
        "hr_attention_core": [P, I, P, I, P, I, I, I, I, I, I, P, P,
                              P, I, I, P, P, P, P, P, I, P],
    },
    "wavlm_attention": {
        "hr_last_kernel": [],
        "hr_onepass_instance": [I, I, I],
        "hr_onepass_smem_bytes": [I, I, I, I, I],
        "hr_onepass_max_smem_bytes": [],
        "hr_onepass_attention": [I, P, I, I, I, P, I, I, I, P, I, I, I, I, I, I, I, I, F,
                                 P, P, P, P, I, I, I, I, P],
    },
    "flash_attention": {
        "hr_last_kernel": [],
        "hr_streaming_instance": [I, I],
        "hr_streaming_attention": [I, P, I, I, I, P, I, I, I, P, I, I, I, I, I, I, I, I, F,
                                   P, P, I, I, I, I, P],
    },
    "ffn_bf16": {
        "hr_ffn_gemms": [I, P, P, P, P, P, I, I, I, I, P, P, P],
    },
    "conv_stack": {
        "hr_conv_stats": [I, P, I, I, P, I, I, P, P, P],
        "hr_conv0_gn": [I, P, I, I, P, P, P, P, F, F, I, I, P, P],
        "hr_conv_s2": [I, P, L, I, I, P, I, I, I, P, P],
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
                    "streaming_wide_kernel", "attn_tf32_kernel", "attn_tf32_wide_kernel")


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
    return q, s


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
    return out
