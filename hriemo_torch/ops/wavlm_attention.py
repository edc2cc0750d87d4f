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
is cast to v's dtype before PV. On the card it is one launch of the kernel
that :func:`onepass_kernel` picks from the shape: in bf16 and fp16 at head
dims 64 and 96 the wgmma warpgroups of ``csrc/onepass_wgmma.cuh``
(``csrc/attention_wgmma.cu``: every score held up to 512 keys, two sweeps
beyond), else the ``mma.sync`` and 3xTF32 kernels of
``csrc/wavlm_attention.cu`` (see each for what bounds it); the same launch
without a gate is the one-pass kernel of ``ops/flash_attention``.
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

import collections
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


# The one-pass core's kernels on the card, as onepass_kernel names them:
# csrc/wavlm_attention.cu's mma.sync (and 3xTF32) two sweeps, and
# csrc/attention_wgmma.cu's wgmma warpgroups, every score held ("wgmma") or
# in two sweeps ("wgmma_sweeps"), by hr_onepass_wgmma's kernel code
ONEPASS_KERNELS = ("mma", "wgmma", "wgmma_sweeps")
WGMMA_CODES = {"wgmma": 1, "wgmma_sweeps": 2}
WGMMA_DTYPES = (torch.bfloat16, torch.float16)
HELD_MAX_KEYS = 512       # the held form's scores in registers (csrc kWgMaxKeys)
SWEEPS_MAX_KEYS = 2048    # the two sweeps' key biases in shared memory (kSwMaxKeys)
WGMMA_HEAD_DIMS = (64, 96)
WIDE_HEAD_DIMS = range(136, 257, 8)  # the wide tiles 192 and 256, ungated
SWEEPS_ROWS = 128         # query rows of a block of the two sweeps (csrc kSwRows)


def tma_view(strides, itemsize: int = 2) -> bool:
    """Whether TMA tensor maps can describe q/k/v with these (batch, head,
    row) strides in elements: each a multiple of 16 bytes and below 2^40
    bytes (``cuTensorMapEncodeTiled``'s terms; 0 is a dimension of size 1)."""
    return all(s >= 0 and (s * itemsize) % 16 == 0 and s * itemsize < 1 << 40
               for s in strides)


def onepass_kernels(lk: int, hd: int, gated: bool, dtype) -> tuple[str, ...]:
    """Every kernel of :data:`ONEPASS_KERNELS` that takes ``lk`` keys at
    head dim ``hd``, gated or not, in ``dtype`` (q/k/v that TMA can
    describe): "mma" always; "wgmma" at 64 and 96 up to 512 keys in bf16 and
    fp16; "wgmma_sweeps" there up to 2048 keys, and ungated at 136-256."""
    out = ["mma"]
    if dtype in WGMMA_DTYPES and lk <= SWEEPS_MAX_KEYS:
        if hd in WGMMA_HEAD_DIMS and lk <= HELD_MAX_KEYS:
            out.append("wgmma")
        if hd in WGMMA_HEAD_DIMS or (hd in WIDE_HEAD_DIMS and not gated):
            out.append("wgmma_sweeps")
    return tuple(out)


# How much slower than the fastest kernel that takes a shape the rule's may
# read (chip_smoke.py phase 3, tests/test_torch_cuda.py): one kernel's
# reading moves by up to 2% between calls on the card.
ONEPASS_ROUTE_MARGIN = 0.05
# The rule's constants, from chip_onepass_routes.py on the H100 (80GB HBM3,
# 700 W; PERF.md section 6, PR 24 call 4), ms of "mma" (the parent's
# mma.sync two sweeps, 64-row blocks, up to four an SM at 64 and 96, one at
# the wide tiles) against the wgmma kernels (one block of 128 rows an SM in
# the two sweeps):
# - up to 512 keys at 64 and 96 the held form, at every reading: gated B=64
#   L=249 0.1478 against 0.2110, B=32 L=499 0.2431 against 0.4032, B=4 L=65
#   0.0065 against 0.0104; ungated 8 x 96 B=4 L=512 0.0275 against 0.0379;
# - past 512 keys at 64 and 96 the two sweeps from SWEEPS_MIN_WAVES waves of
#   their blocks: gated 12 x 64 B=4 L=513 (1.82 waves) 0.0726 against 0.0889,
#   B=2 L=1499 (2.18) 0.2603 against 0.2614, B=1 L=1499 (1.09) 0.1806 against
#   0.1576; ungated 8 x 96 B=4 L=1024 (1.94) 0.0996 against 0.1336, B=2
#   L=1499 (1.45) 0.1455 against 0.1333, B=4 L=513 (1.21) 0.0592 against
#   0.0536; 4 x 64 B=16 L=1951 (7.76) 0.6589 against 0.7347;
# - on the wide tiles (ungated, 136-256) the two sweeps where the parent's
#   rounds of blocks (twice the blocks, one an SM) outnumber the sweeps'
#   rounds by more than WIDE_ROUNDS_RATIO, the sweeps' cost of a 128-row
#   block in the parent's 64-row blocks at full grids: 4 x 192 B=8 L=1499
#   (3 rounds against 6) 0.3790 against 0.6401, so 2 x 0.59; 1 x 256 B=32
#   L=1951 (4 against 8) 1.1915 against 1.2862, 2 x 0.93. Where the rounds
#   are 1 against 1 (B=4 L=512 4 x 192: 0.0482 against 0.0426; B=4 L=2048 1 x
#   256: 0.3119 against 0.1738) or, at 256, 2 against 3 (B=12 L=1951 1 x 256:
#   0.5978 against 0.4903), the parent; 1 against 2 (B=2 L=1499 4 x 192:
#   0.1283 against 0.2216; B=8 L=1951 1 x 256: 0.3062 against 0.3307) and 2
#   against 4 (B=16 L=1951 1 x 256: 0.6084 against 0.6471), the sweeps.
SWEEPS_MIN_WAVES = 1.8
WIDE_ROUNDS_RATIO = {192: 1.18, 256: 1.85}


def onepass_kernel(lk: int, hd: int, gated: bool, dtype, strides=(), b: int = 1, h: int = 1,
                   lq: int | None = None, sms: int = _cuda.H100_SMS) -> str:
    """The kernel of :data:`ONEPASS_KERNELS` that the one-pass core takes
    for ``b`` elements of ``h`` heads, ``lq`` query rows (None: ``lk``)
    and ``lk`` keys at head dim ``hd``, gated or not, in ``dtype``, with
    q/k/v at ``strides`` (their batch, head and row strides in elements),
    on a card of ``sms`` SMs. "mma" for fp32, views TMA cannot describe
    (:func:`tma_view`), head dims off 64, 96 and 136-256 (32, 40 and 128
    among them), the gate off 64 and 96, past 2048 keys, and where the card
    read it faster (the constants above); else "wgmma" (every score held) at
    64 and 96 up to 512 keys, and "wgmma_sweeps"."""
    kernels = onepass_kernels(lk, hd, gated, dtype)
    if len(kernels) == 1 or not tma_view(strides):
        return "mma"
    if "wgmma" in kernels:
        return "wgmma"
    blocks = b * h * -(-(lk if lq is None else lq) // SWEEPS_ROWS)
    if hd in WGMMA_HEAD_DIMS:
        return "wgmma_sweeps" if blocks >= SWEEPS_MIN_WAVES * sms else "mma"
    rounds, parent_rounds = -(-blocks // sms), -(-2 * blocks // sms)
    ratio = WIDE_ROUNDS_RATIO[192 if hd <= 192 else 256]
    return "wgmma_sweeps" if parent_rounds > ratio * rounds else "mma"


def _strides(*ts):
    """The (batch, head, row) strides of each ``[B, H, L, hd]`` view, 0 for
    a dimension of size 1 (as ``_cuda.heads_operand`` passes them)."""
    return [s if n > 1 else 0 for t in ts for s, n in zip(t.stride()[:3], t.shape[:3])]


def onepass_route(q, k, v, gated: bool) -> str:
    """:func:`onepass_kernel` for these operands."""
    b, h, lq, hd = q.shape
    return onepass_kernel(k.shape[2], hd, gated, q.dtype, _strides(q, k, v), b, h, lq,
                          _cuda.sm_count())


def onepass_launch(q, k, v, kbias, gate=None, pos=None, cuda_cores: bool = False,
                   kernel: str | None = None):
    """Launch the one-pass core on ``[B, H, L, hd]`` q/k/v views (any batch,
    head and row strides). ``gate [B, H, Lq]`` fp32 and ``pos [H, Lq, Lk]``
    of q's dtype, or both None. Returns ``[B, H, Lq, hd]``, a head view of a
    contiguous ``[B, Lq, H*hd]`` tensor. ``kernel``: one of
    :data:`ONEPASS_KERNELS` (None: :func:`onepass_route`'s); "mma" runs
    ``csrc/wavlm_attention.cu``'s instance for the head dim, or with
    ``cuda_cores`` its CUDA-core kernel at any head dim (a yardstick); a
    shape the kernel does not take raises."""
    gated = gate is not None
    if kernel is None:
        kernel = "mma" if cuda_cores else onepass_route(q, k, v, gated)
    if kernel not in ONEPASS_KERNELS or (cuda_cores and kernel != "mma"):
        raise ValueError(f"one-pass attention kernel: no kernel {kernel!r}"
                         f"{' on CUDA cores' if cuda_cores else ''}")
    args, o = _cuda.attention_operands(q, k, v, kbias, "one-pass attention kernel")
    b, h, lq, hd = q.shape
    lk = k.shape[2]
    if gated:
        _cuda.require(gate, "gate", torch.float32, (b, h, lq), q.device)
        _cuda.require(pos, "position_bias", q.dtype, (h, lq, lk), q.device)
    tail = (_cuda.ptr(gate), _cuda.ptr(pos), o.data_ptr(), *o.stride()[:3])
    if kernel == "mma":
        lib = _cuda.lib("wavlm_attention")
        if (lib.hr_onepass_smem_bytes(args[0], lk, hd, gated, cuda_cores)
                > lib.hr_onepass_max_smem_bytes()):
            raise ValueError(f"one-pass attention kernel: the score panel of key length {lk} "
                             f"at head dim {hd} in {q.dtype} does not fit shared memory")
        _cuda.check(lib.hr_onepass_attention(*args, *tail, cuda_cores, _cuda.stream()),
                    "hr_onepass_attention")
    else:
        _cuda.check(_cuda.lib("attention_wgmma").hr_onepass_wgmma(
            *args, *tail, WGMMA_CODES[kernel], _cuda.stream()),
            f"hr_onepass_wgmma ({kernel}, {q.dtype}, hd {hd}, {lk} keys, gated {gated})")
    return o


class _WavlmFusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, gate, position_bias, key_padding_bias, kernel):
        ctx.save_for_backward(q, k, v, gate, position_bias, key_padding_bias)
        if q.device.type == "cpu":
            return wavlm_fused_attention_plain(q, k, v, gate, position_bias, key_padding_bias)
        kernel = kernel or onepass_route(q, k, v, True)
        out = onepass_launch(q, k, v, key_padding_bias, gate.to(torch.float32).contiguous(),
                             position_bias, kernel=kernel)
        wavlm_fused_attention.launches += 1
        wavlm_fused_attention.kernels[kernel] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        ins = [t.detach().requires_grad_(need)
               for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = wavlm_fused_attention_plain(*ins)
            want = [t for t in ins if t.requires_grad]
            grads = iter(torch.autograd.grad(out, want, g))
        return (*(next(grads) if t.requires_grad else None for t in ins), None)


def wavlm_fused_attention(q, k, v, gate, position_bias, key_padding_bias,
                          kernel: str | None = None):
    """q/k/v ``[B, H, L, hd]`` (bf16, fp16 or fp32; views with any strides are
    read in place); gate ``[B, H, L]``; position_bias ``[H, L, L]`` of q's
    dtype; key_padding_bias ``[B, L]`` fp32 additive. Returns ``[B, H, L,
    hd]`` in q's dtype. The gate is widened to fp32 first, as the TPU wrapper
    does. Differentiable in every input; the backward recomputes through
    :func:`wavlm_fused_attention_plain`. On the card, ``kernel`` forces one
    of :data:`ONEPASS_KERNELS` (None: :func:`onepass_route`'s);
    ``.launches`` counts launches, ``.kernels`` the same by kernel."""
    return _WavlmFusedAttention.apply(q, k, v, gate, position_bias, key_padding_bias, kernel)


wavlm_fused_attention.launches = 0
wavlm_fused_attention.kernels = collections.Counter()


def use_fused(l: int, hd: int) -> bool:
    """``hriemo/ops/wavlm_attention.py::use_fused`` without the device test."""
    return 128 <= l <= 2048 and hd % 8 == 0 and hd <= 256
