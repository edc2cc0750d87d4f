"""Fused WavLM gated-relative-position-bias attention (port of
``hriemo/ops/wavlm_attention.py``).

:func:`wavlm_fused_attention` replaces the Pallas kernel ``_kernel``
(``hriemo/ops/wavlm_attention.py:34``, launched at ``:87``): the attention
core over already projected q/k/v with WavLM's per-(batch, head, query)
gate times the shared ``[H, L, L]`` position bias and the key-padding bias
added to the scores, one-pass softmax, without materializing the
``[B, H, L, L]`` gated bias or scores in device memory. It is the WavLM
route of float (bf16 or fp32) trees, and of int8 trees at lengths the int8
sublayer kernel does not take (``frontends/wavlm.py``).

Its numerics are the TPU kernel's, not the per-op branch's: the fp32 dot is
scaled after the product, ``gate * pos`` is formed in fp32, and ``p / l``
is cast to v's dtype before PV. On the card it is one launch of
``csrc/wavlm_attention.cu`` (see there for what bounds it); the same
launch without a gate is the one-pass kernel of ``ops/flash_attention``.
The TPU wrapper pads L to its 128-row tiles; the port runs at the true
length, which gives the same rows except where every key is masked (TPU
tiling then decides the average; the port's output is finite there too).

It is differentiable as the JAX ``custom_vjp`` is (``:118-142``): the
kernel forward, and a backward that recomputes through
:func:`wavlm_fused_attention_plain` on the saved inputs. The backward never
reads the kernel's output, so on one device the kernel route's gradients
are the plain route's, bit for bit.
"""

from __future__ import annotations

import math

import torch

from . import _cuda
from .attention_block import softmax_pv


def scaled_scores(q, k):
    """``(q . k^T) * (1/sqrt(hd))`` in fp32, scaled after the product as the
    TPU kernels scale it."""
    return (q.float() @ k.float().transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))


def wavlm_fused_attention_plain(q, k, v, gate, position_bias, key_padding_bias):
    """Plain PyTorch version of :func:`wavlm_fused_attention`."""
    s = scaled_scores(q, k)
    s = s + gate.float()[..., None] * position_bias.float()[None]
    s = s + key_padding_bias.float()[:, None, None, :]
    return softmax_pv(s, v)


def onepass_launch(q, k, v, kbias, gate=None, pos=None, cuda_cores: bool = False):
    """Launch ``csrc/wavlm_attention.cu`` on ``[B, H, L, hd]`` q/k/v views
    (any batch, head and row strides). ``gate [B, H, Lq]`` fp32 and ``pos
    [H, Lq, Lk]`` of q's dtype, or both None. Returns ``[B, H, Lq, hd]``, a
    head view of a contiguous ``[B, Lq, H*hd]`` tensor. The kernel is the
    one ``hr_onepass_instance`` names for the head dim, or with
    ``cuda_cores`` the CUDA-core kernel at any head dim (a yardstick)."""
    args, o = _cuda.attention_operands(q, k, v, kbias, "one-pass attention kernel")
    b, h, lq, hd = q.shape
    lk = k.shape[2]
    lib = _cuda.lib("wavlm_attention")
    gated = gate is not None
    if (lib.hr_onepass_smem_bytes(args[0], lk, hd, gated, cuda_cores)
            > lib.hr_onepass_max_smem_bytes()):
        raise ValueError(f"one-pass attention kernel: the score panel of key length {lk} "
                         f"at head dim {hd} in {q.dtype} does not fit shared memory")
    if gated:
        _cuda.require(gate, "gate", torch.float32, (b, h, lq), q.device)
        _cuda.require(pos, "position_bias", q.dtype, (h, lq, lk), q.device)
    _cuda.check(lib.hr_onepass_attention(*args, _cuda.ptr(gate), _cuda.ptr(pos), o.data_ptr(),
                                         *o.stride()[:3], cuda_cores, _cuda.stream()),
                "hr_onepass_attention")
    return o


class _WavlmFusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, gate, position_bias, key_padding_bias):
        ctx.save_for_backward(q, k, v, gate, position_bias, key_padding_bias)
        if q.device.type == "cpu":
            return wavlm_fused_attention_plain(q, k, v, gate, position_bias, key_padding_bias)
        out = onepass_launch(q, k, v, key_padding_bias, gate.to(torch.float32).contiguous(),
                             position_bias)
        wavlm_fused_attention.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        ins = [t.detach().requires_grad_(need)
               for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = wavlm_fused_attention_plain(*ins)
            want = [t for t in ins if t.requires_grad]
            grads = iter(torch.autograd.grad(out, want, g))
        return tuple(next(grads) if t.requires_grad else None for t in ins)


def wavlm_fused_attention(q, k, v, gate, position_bias, key_padding_bias):
    """q/k/v ``[B, H, L, hd]`` (bf16, fp16 or fp32; views with any strides are
    read in place); gate ``[B, H, L]``; position_bias ``[H, L, L]`` of q's
    dtype; key_padding_bias ``[B, L]`` fp32 additive. Returns ``[B, H, L,
    hd]`` in q's dtype. The gate is widened to fp32 first, as the TPU wrapper
    does. Differentiable in every input; the backward recomputes through
    :func:`wavlm_fused_attention_plain`."""
    return _WavlmFusedAttention.apply(q, k, v, gate, position_bias, key_padding_bias)


wavlm_fused_attention.launches = 0


def use_fused(l: int, hd: int) -> bool:
    """``hriemo/ops/wavlm_attention.py::use_fused`` without the device test."""
    return 128 <= l <= 2048 and hd % 8 == 0 and hd <= 256
