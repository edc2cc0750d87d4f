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
  end. On the card it is the kernel :func:`streaming_kernel` picks: in
  bf16 and fp16 the wgmma warpgroups of ``csrc/streaming_wgmma.cu``, else
  the ``mma.sync`` and 3xTF32 kernels of ``csrc/flash_attention.cu``.

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
from .wavlm_attention import (WGMMA_DTYPES, _strides, onepass_launch, onepass_route,
                              scaled_scores, tma_view)

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


# The streaming core's kernels on the card, as streaming_kernel names them:
# csrc/flash_attention.cu's mma.sync kernels (and 3xTF32), and
# csrc/streaming_wgmma.cu's wgmma warpgroups fed by a producer warp, 128
# query rows a block ("wgmma", the instances 32-128) or 64 with O split
# between the two warpgroups ("wgmma_split", 128-256), by
# hr_streaming_wgmma's kernel code
STREAMING_KERNELS = ("mma", "wgmma", "wgmma_split")
STREAMING_WGMMA_CODES = {"wgmma": 1, "wgmma_split": 2}
STREAMING_ROWS = {"wgmma": 128, "wgmma_split": 64}   # query rows of a block


def streaming_kernels(hd: int, dtype) -> tuple[str, ...]:
    """Every kernel of :data:`STREAMING_KERNELS` that takes head dim ``hd``
    in ``dtype`` (q/k/v that TMA can describe): "mma" always; in bf16 and
    fp16 "wgmma" up to 128 and "wgmma_split" from 104 (the instance 128) to
    256."""
    out = ["mma"]
    if dtype in WGMMA_DTYPES and hd % 8 == 0 and 8 <= hd <= 256:
        if hd <= 128:
            out.append("wgmma")
        if hd > 96:
            out.append("wgmma_split")
    return tuple(out)


# How much slower than the fastest kernel that takes a shape the rule's may
# read (chip_smoke.py phase 3, tests/test_torch_cuda.py), as the one-pass
# core's margin.
STREAMING_ROUTE_MARGIN = 0.05
# The rule's constants, from chip_onepass_routes.py --streaming on the H100
# (80GB HBM3, 700 W; the ladder in PERF.md section 6). A kernel's time
# follows the blocks its busiest SM takes, ceil(blocks / SMs), in units of
# one 128-row "wgmma" block; a 64-row block of the parent ("mma", by its
# instance) or of the O split costs the fraction below. At full grids (B=16
# L=2249, ms of "mma" against "wgmma", blocks an SM 35 or 18 against 18 or
# 9): 8 x 32 0.7577 against 0.5933, 0.66; 4 x 64 0.5560 against 0.3719,
# 0.75; 8 x 96 1.4157 against 0.8816, 0.83; 2 x 128 at B=32 1.0993 against
# 0.5108, 1.08; the split there 0.6053, 0.59 (0.74 at hd 104: 0.7751
# against 0.5236), so 0.66 between. The thin grids it decides: 4 x 64 B=2
# L=2049 (2 blocks an SM either way) "mma" 0.0627 against 0.0833; 2 x 128 B=2
# L=2249 (1 against 2) "wgmma" 0.0602 against the split's 0.0712, at B=4 (2
# against 3) the split 0.1088 against 0.1189, B=8 (3 against 5) 0.1789
# against 0.1795. Above 128 the split, 2.0-2.4x faster than the parent at
# every reading (1 x 256 and 4 x 192 at B=1-32, 2049-4096 keys).
MMA_BLOCK_COST = {32: 0.66, 64: 0.75, 96: 0.83, 128: 1.08}
SPLIT_BLOCK_COST = 0.66


def streaming_kernel(lk: int, hd: int, dtype, strides=(), b: int = 1, h: int = 1,
                     lq: int | None = None, sms: int = _cuda.H100_SMS) -> str:
    """The kernel of :data:`STREAMING_KERNELS` that the streaming core takes
    for ``b`` elements of ``h`` heads, ``lq`` query rows (None: ``lk``) and
    ``lk`` keys at head dim ``hd`` in ``dtype``, with q/k/v at ``strides``
    (their batch, head and row strides in elements), on a card of ``sms``
    SMs. "mma" for fp32, views TMA cannot describe (:func:`tma_view`) and
    head dims no wgmma instance takes; "wgmma_split" above 128; up to 128 the
    least of the kernels' costs (the blocks of the busiest SM at
    :data:`MMA_BLOCK_COST` and :data:`SPLIT_BLOCK_COST`), "wgmma" on a tie."""
    kernels = streaming_kernels(hd, dtype)
    if len(kernels) == 1 or not tma_view(strides):
        return "mma"
    if "wgmma" not in kernels:
        return "wgmma_split"
    rows = lk if lq is None else lq

    def per_sm(block_rows):
        return -(-(b * h * -(-rows // block_rows)) // sms)

    cost = {"wgmma": per_sm(STREAMING_ROWS["wgmma"]),
            "mma": MMA_BLOCK_COST[-(-hd // 32) * 32] * per_sm(64)}
    if "wgmma_split" in kernels:
        cost["wgmma_split"] = SPLIT_BLOCK_COST * per_sm(STREAMING_ROWS["wgmma_split"])
    return min(cost, key=cost.get)


def streaming_route(q, k, v) -> str:
    """:func:`streaming_kernel` for these operands."""
    b, h, lq, hd = q.shape
    return streaming_kernel(k.shape[2], hd, q.dtype, _strides(q, k, v), b, h, lq,
                            _cuda.sm_count())


def streaming_launch(q, k, v, bias, cuda_cores: bool = False, kernel: str | None = None):
    """Launch the streaming core on CUDA tensors. ``kernel``: one of
    :data:`STREAMING_KERNELS` (None: :func:`streaming_route`'s); "mma" runs
    ``csrc/flash_attention.cu``'s instance for the head dim
    (``hr_streaming_instance``), or with ``cuda_cores`` its CUDA-core
    kernel at any head dim (a yardstick); a shape the kernel does not take
    raises."""
    if kernel is None:
        kernel = "mma" if cuda_cores else streaming_route(q, k, v)
    if kernel not in STREAMING_KERNELS or (cuda_cores and kernel != "mma"):
        raise ValueError(f"streaming attention kernel: no kernel {kernel!r}"
                         f"{' on CUDA cores' if cuda_cores else ''}")
    args, o = _cuda.attention_operands(q, k, v, bias, "streaming attention kernel")
    tail = (o.data_ptr(), *o.stride()[:3])
    if kernel == "mma":
        _cuda.check(_cuda.lib("flash_attention").hr_streaming_attention(
            *args, *tail, cuda_cores, _cuda.stream()), "hr_streaming_attention")
    else:
        _cuda.check(_cuda.lib("streaming_wgmma").hr_streaming_wgmma(
            *args, *tail, STREAMING_WGMMA_CODES[kernel], _cuda.stream()),
            f"hr_streaming_wgmma ({kernel}, {q.dtype}, hd {q.shape[-1]}, {k.shape[2]} keys)")
    return o


def streaming_attention(q, k, v, bias, kernel: str | None = None):
    """Same arguments as :func:`onepass_attention`; any key length. On the
    card, ``kernel`` forces one of :data:`STREAMING_KERNELS` (None:
    :func:`streaming_route`'s); ``.kernels`` counts launches by kernel."""
    if q.device.type == "cpu":
        return streaming_attention_plain(q, k, v, bias)
    kernel = kernel or streaming_route(q, k, v)
    o = streaming_launch(q, k, v, bias, kernel=kernel)
    streaming_attention.launches += 1
    streaming_attention.head_dims[(q.shape[-1], q.dtype)] += 1
    streaming_attention.kernels[kernel] += 1
    return o


streaming_attention.launches = 0
streaming_attention.head_dims = collections.Counter()
streaming_attention.kernels = collections.Counter()


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
