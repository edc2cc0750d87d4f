"""int8 serving quantization, W8A8 (port of ``hriemo/ops/quant.py:56-199``).

* :func:`quantize_linear_params`: one-time symmetric per-output-channel
  weight quantization of a torch-layout ``[out, in]`` weight.
* :func:`int8_linear`: dynamic per-row activation quantization, an exact
  int8 x int8 -> int32 product, and an fp32 dequant epilogue. On the card it
  runs through the port's own int8 GEMM (``csrc/int8_gemm.cuh``).
* :func:`quantize_for_serving`: the ``quantize_tree_for_serving`` rule on a
  module tree. Every Linear with both dims >= ``min_dim`` and every packed
  MHA ``in_proj`` becomes int8; nothing under ``embeddings`` or
  ``rel_attn_embed`` is touched. Quantize after the bf16 cast, as the
  serving pipeline does: the int8 weights and scales are then bit-equal to
  the JAX package's.

Both scale formulas of the reference are kept where they are used: this
module's ``max(amax, eps) / 127`` and the kernels' ``max(amax, eps) * (1/127)``
(``ops/fused_ffn.quant_rows``); they can differ by one ulp.
"""

from __future__ import annotations

import torch

from . import _cuda

# Quantizing a Linear only pays when the GEMM is big; tiny projections (e.g.
# WavLM's 8-wide gate head) stay in the compute dtype.
DEFAULT_MIN_DIM = 256
SKIP = ("embeddings", "rel_attn_embed")


def _div127(m: torch.Tensor) -> torch.Tensor:
    """``m / 127`` as an IEEE division on every device. PyTorch's CUDA
    kernels turn a division by a Python scalar into a multiply by its
    fp32 reciprocal, which is one ulp off for some ``m``; a tensor divisor
    keeps the true division of the JAX package (``quant.py:63,77``)."""
    return m / m.new_full((), 127.0)


def quantize_rowwise(x: torch.Tensor, eps: float = 1e-8):
    """Symmetric per-row int8 quantization over the last axis.

    Returns ``(q int8, scale fp32 [..., 1])`` with ``q * scale ~= x``;
    ``torch.round`` rounds half to even, as ``jnp.round`` does.
    """
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = _div127(amax.clamp_min(eps))
    q = torch.round(xf / scale).clamp_(-127, 127)
    return q.to(torch.int8), scale


def quantize_linear_params(weight: torch.Tensor, eps: float = 1e-8):
    """``[out, in]`` weight -> ``(w_int8 [out, in], w_scale [out, 1] fp32)``."""
    w = weight.detach().float()
    amax = w.abs().amax(dim=1, keepdim=True)
    scale = _div127(amax.clamp_min(eps))
    q = torch.round(w / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale


def int8_matmul_exact(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a [M, K] int8 . w [N, K]^T int8`` as fp32, exact up to the final
    int32 -> fp32 rounding: the product runs in float64, where every
    partial sum (at most 3072 * 127^2 < 2^53) is an exact integer."""
    return (a.double() @ w.double().t()).float()


def int8_linear_plain(x, w_int8, w_scale, bias=None):
    """Plain PyTorch version of :func:`int8_linear` (same arguments)."""
    shape = x.shape
    xq, xs = quantize_rowwise(x.reshape(-1, shape[-1]))
    y = int8_matmul_exact(xq, w_int8) * xs * w_scale[:, 0]
    if bias is not None:
        y = y + bias
    return y.to(x.dtype).reshape(*shape[:-1], w_int8.shape[0])


def int8_linear(x, w_int8, w_scale, bias=None):
    """``x @ W^T + b`` with W pre-quantized (``[out, in]`` int8, ``[out, 1]``
    fp32 scales) and x quantized per row on the fly; ``bias`` fp32 or None.

    Replaces no Pallas kernel: in JAX this is XLA's int8 ``dot_general``
    (``hriemo/ops/quant.py:85``). On the card it is one row-quantize launch
    and one launch of the shared int8 GEMM (``csrc/int8_gemm.cuh``), whose
    epilogue applies the dequant and bias and stores x's dtype (bf16 or
    fp32, as the JAX function returns ``x.dtype``). It is bound by
    the weight bytes at the decoder's few rows and by int8 tensor-core
    operations at WavLM's feature projection.
    """
    if x.device.type == "cpu":
        return int8_linear_plain(x, w_int8, w_scale, bias)
    shape = x.shape
    n, k = w_int8.shape
    x2 = x.reshape(-1, k)
    _cuda.require(x2, "x", _cuda.ACT_DTYPES)
    _cuda.require(w_int8, "w_int8", torch.int8, (n, k), x.device)
    _cuda.require(w_scale, "w_scale", torch.float32, (n, 1), x.device)
    if bias is not None:
        _cuda.require(bias, "bias", torch.float32, (n,), x.device)
    xq, xs = _cuda.rowquant(x2, div127=True)
    y = _cuda.int8_gemm(xq, xs, w_int8, w_scale, bias, _cuda.out_epi(x.dtype))
    int8_linear.launches += 1
    return y.reshape(*shape[:-1], n)


int8_linear.launches = 0


def quantize_for_serving(module: torch.nn.Module, min_dim: int = DEFAULT_MIN_DIM,
                         skip=SKIP) -> torch.nn.Module:
    """Quantize ``module`` in place by the ``quantize_tree_for_serving`` rule
    and derive every kernel's operands. Returns ``module``.

    Modules that can be quantized define ``quantize_(min_dim)``; modules
    that hand operands to a kernel define ``prepare_kernels()``, which runs
    once all weights are int8. Move the module to its device first: the
    derived operands are plain tensors that ``.to()`` does not move.
    """
    mods = [(name, m) for name, m in module.named_modules()
            if not any(s in name.split(".") for s in skip)]
    for _, m in mods:
        if hasattr(m, "quantize_"):
            m.quantize_(min_dim)
    for _, m in module.named_modules():
        if hasattr(m, "prepare_kernels"):
            m.prepare_kernels()
    return module


def count_quantized(module: torch.nn.Module) -> int:
    """Number of int8 Linears and packed MHA in_projs in ``module``."""
    return sum(getattr(m, "w_int8", None) is not None
               or getattr(m, "in_proj_w_int8", None) is not None
               for m in module.modules())
