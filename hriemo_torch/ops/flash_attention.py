"""Fused attention for long sequences (port of ``hriemo/ops/flash_attention.py``
and ``hriemo/ops/flash_attention_pallas.py``).

:func:`flash_mha` takes already projected per-head q/k/v ``[B, H, L, hd]``
and a ``[B, Lk]`` True = PAD key-padding mask, and never materializes the
``[B, H, Lq, Lk]`` scores in device memory. It dispatches on the key length
as ``flash_attention_pallas.py:274-277`` does:

* :func:`onepass_attention` for ``Lk <= ONEPASS_MAX_LK`` replaces the Pallas
  kernel ``_onepass_kernel`` (``flash_attention_pallas.py:81``, launched at
  ``:126``): one-pass softmax, ``p / l`` cast to v's dtype before PV. On the
  card it is the one-pass launch of ``csrc/wavlm_attention.cu`` without a
  gate.
* :func:`streaming_attention` beyond that replaces ``_flash_kernel``
  (``:38``, launched at ``:182``): an online softmax over 128-key blocks,
  the unnormalized p block cast to v's dtype before PV, ``acc / l`` at the
  end. On the card it is ``csrc/flash_attention.cu``.

On the card both run on the tensor cores at every head dim up to 256 in
bf16, fp16 and fp32 (3xTF32), the head dim zero-padded inside the kernel to
the next of 32, 64, 96, 128, 192 and 256. ``.launches`` of each counts its
launches, ``.head_dims`` the same by ``(head dim, dtype)``.

The two keep their own numerics, each its TPU kernel's. Both scale the fp32
dot after the product, where the per-op branch of ``nn/attention.py``
scales q first. The caller routes here when :func:`use_flash` holds
(``nn/attention.py``). The TPU wrappers pad the keys to 128 with NEG_INF;
the port runs at the true length, which gives the same rows except where
every key is masked (finite output all the same).

:func:`flash_mha` is differentiable as ``_pallas_mha``'s custom VJP is
(``flash_attention_pallas.py:280-299``): the kernel forward, and a backward
that recomputes through :func:`streaming_reference`, an online softmax over
``REF_BLOCK``-key blocks with each block under ``torch.utils.checkpoint``
(``_streaming_reference``, ``:226-271``). Neither direction builds the
``[B, H, Lq, Lk]`` panel, which is why the route exists at L >= 1024.
Gradients flow to q, k and v; the key bias comes from the mask and takes
none.
"""

from __future__ import annotations

import collections
import math

import torch
from torch.utils.checkpoint import checkpoint

from ..core.masking import NEG_INF
from . import _cuda
from .attention_block import softmax_pv
from .wavlm_attention import onepass_launch, onepass_route, scaled_scores

# one-pass path while K/V and the fp32 score panel fit (flash_attention_pallas.py:107)
ONEPASS_MAX_LK = 2048
BK = 128  # keys per step of the streaming softmax (flash_attention_pallas.py:35)
REF_BLOCK = 512  # keys per recomputed block of the backward (flash_attention_pallas.py:226)


def onepass_attention_plain(q, k, v, bias):
    """Plain PyTorch version of :func:`onepass_attention`."""
    return softmax_pv(scaled_scores(q, k) + bias.float()[:, None, None, :], v)


def onepass_attention(q, k, v, bias, kernel: str | None = None):
    """q ``[B, H, Lq, hd]``, k/v ``[B, H, Lk, hd]`` (bf16, fp16 or fp32, views read in
    place), bias ``[B, Lk]`` fp32 additive. Returns ``[B, H, Lq, hd]``. On
    the card, ``kernel`` forces one of ``ONEPASS_KERNELS`` (None: the
    rule's, ``ops/wavlm_attention.py onepass_kernel``)."""
    if q.device.type == "cpu":
        return onepass_attention_plain(q, k, v, bias)
    kernel = kernel or onepass_route(q, k, v, False)
    out = onepass_launch(q, k, v, bias, kernel=kernel)
    onepass_attention.launches += 1
    onepass_attention.head_dims[(q.shape[-1], q.dtype)] += 1
    onepass_attention.kernels[kernel] += 1
    return out


onepass_attention.launches = 0
onepass_attention.head_dims = collections.Counter()
onepass_attention.kernels = collections.Counter()


def streaming_attention_plain(q, k, v, bias):
    """Plain PyTorch version of :func:`streaming_attention`: the same
    128-key steps in the same order."""
    b, h, lq, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    qf = q.float()
    m = torch.full((b, h, lq, 1), -math.inf, device=q.device)
    l = torch.zeros((b, h, lq, 1), device=q.device)
    acc = torch.zeros((b, h, lq, hd), device=q.device)
    for j0 in range(0, k.shape[2], BK):
        kb, vb = k[:, :, j0:j0 + BK], v[:, :, j0:j0 + BK]
        s = (qf @ kb.float().transpose(-1, -2)) * scale + bias.float()[:, None, None, j0:j0 + BK]
        m_cur = torch.maximum(s.amax(dim=-1, keepdim=True), m)
        alpha = torch.exp(m - m_cur)
        p = torch.exp(s - m_cur)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p.to(v.dtype).float() @ vb.float()
        m = m_cur
    return (acc / l).to(q.dtype)


def streaming_launch(q, k, v, bias, cuda_cores: bool = False):
    """Launch ``csrc/flash_attention.cu`` on CUDA tensors: the kernel that
    ``hr_streaming_instance`` names for the head dim, or with ``cuda_cores``
    the CUDA-core kernel at any head dim (a yardstick)."""
    args, o = _cuda.attention_operands(q, k, v, bias, "streaming attention kernel")
    _cuda.check(_cuda.lib("flash_attention").hr_streaming_attention(
        *args, o.data_ptr(), *o.stride()[:3], cuda_cores, _cuda.stream()),
        "hr_streaming_attention")
    return o


def streaming_attention(q, k, v, bias):
    """Same arguments as :func:`onepass_attention`; any key length."""
    if q.device.type == "cpu":
        return streaming_attention_plain(q, k, v, bias)
    o = streaming_launch(q, k, v, bias)
    streaming_attention.launches += 1
    streaming_attention.head_dims[(q.shape[-1], q.dtype)] += 1
    return o


streaming_attention.launches = 0
streaming_attention.head_dims = collections.Counter()


def key_bias(key_padding_mask, b: int, lk: int, device) -> torch.Tensor:
    """``[B, Lk]`` True = PAD mask (or None) -> fp32 additive bias."""
    if key_padding_mask is None:
        return torch.zeros((b, lk), device=device)
    return torch.where(key_padding_mask, NEG_INF, 0.0).float()


def _reference_block(qs, kb, vb, bb, out, m, l):
    """One key block of :func:`streaming_reference` (the scan body of
    ``_streaming_reference``): fp32 scores of the pre-scaled q, the running
    max, ``p`` cast to v's dtype before PV, fp32 sums."""
    s = qs.float() @ kb.float().transpose(-1, -2) + bb[:, None, None, :]
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new)
    l_new = l * alpha + p.sum(dim=-1, keepdim=True)
    pv = p.to(vb.dtype).float() @ vb.float()
    return out * alpha + pv, m_new, l_new


def streaming_reference(q, k, v, bias, blk: int = REF_BLOCK):
    """Online-softmax attention over ``blk``-key blocks, each block under
    ``torch.utils.checkpoint`` (``flash_attention_pallas.py:226-271``):
    differentiating it keeps one block's ``[B, H, Lq, blk]`` scores at a
    time. q ``[B, H, Lq, hd]``, k/v ``[B, H, Lk, hd]``, bias ``[B, Lk]``
    fp32. The last block may be partial: JAX pads it with NEG_INF keys,
    whose weights are exactly 0."""
    b, h, lq, hd = q.shape
    qs = q * (1.0 / math.sqrt(hd))
    out = torch.zeros((b, h, lq, hd), device=q.device)
    m = torch.full((b, h, lq, 1), -math.inf, device=q.device)
    l = torch.zeros((b, h, lq, 1), device=q.device)
    for j0 in range(0, k.shape[2], blk):
        out, m, l = checkpoint(_reference_block, qs, k[:, :, j0:j0 + blk],
                               v[:, :, j0:j0 + blk], bias[:, j0:j0 + blk], out, m, l,
                               use_reentrant=False, preserve_rng_state=False)
    return (out / l).to(q.dtype)


class _FlashMha(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias):
        ctx.save_for_backward(q, k, v, bias)
        fn = onepass_attention if k.shape[2] <= ONEPASS_MAX_LK else streaming_attention
        return fn(q, k, v, bias)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        ins = [t.detach().requires_grad_(need)
               for t, need in zip((q, k, v), ctx.needs_input_grad[:3])]
        with torch.enable_grad():
            out = streaming_reference(*ins, bias)
            want = [t for t in ins if t.requires_grad]
            grads = iter(torch.autograd.grad(out, want, g))
        return (*(next(grads) if t.requires_grad else None for t in ins), None)


def flash_mha(q, k, v, key_padding_mask=None):
    """Fused attention over ``[B, H, L, hd]`` q/k/v: the one-pass kernel up
    to ``ONEPASS_MAX_LK`` keys, the streaming kernel beyond (their plain
    versions for CPU tensors). Differentiable in q, k and v; the backward
    recomputes through :func:`streaming_reference`."""
    return _FlashMha.apply(q, k, v, key_bias(key_padding_mask, q.shape[0], k.shape[2],
                                              q.device))


def flash_mha_plain(q, k, v, key_padding_mask=None):
    """Plain PyTorch version of :func:`flash_mha`, dispatched the same way."""
    fn = onepass_attention_plain if k.shape[2] <= ONEPASS_MAX_LK else streaming_attention_plain
    return fn(q, k, v, key_bias(key_padding_mask, q.shape[0], k.shape[2], q.device))


def use_flash(q_shape, k_shape) -> bool:
    """``hriemo/ops/flash_attention.py::_use_pallas`` without the device test:
    only where the score panel becomes a memory problem."""
    _, _, lq, hd = q_shape
    return lq >= 1024 and k_shape[2] >= 1024 and hd % 8 == 0 and hd <= 256
