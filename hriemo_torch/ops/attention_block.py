"""W8A8 attention sublayers (port of ``hriemo/ops/attention_block.py``).

Two Hopper kernels, each with its plain PyTorch version beside it:

* :func:`attention_block_int8` replaces the Pallas kernel ``_kernel``
  (``hriemo/ops/attention_block.py:169``), the whole post-norm WavLM
  attention sublayer: per-row int8 quantization of x, int8 q/k/v GEMMs
  with 1/sqrt(hd) folded into q's scale and bias, WavLM's gate
  ``sigmoid(sum g[0:4]) * (sigmoid(sum g[4:8]) * c_h - 1) + 2`` from the shared
  hd->8 gate Linear, fp32 scores + gate * pos (bf16) + key bias, fp32
  softmax, p/l -> bf16, PV -> bf16, int8 out-proj, fp32 residual and
  LayerNorm.
* :func:`mha_block_int8` replaces ``_mha_kernel`` (``:508``), a torch-MHA
  sublayer, self or cross: the same int8 projections and core with a
  key-padding bias, returning the output before the residual in xq's dtype,
  or, given the caller's post-norm LayerNorm, ``LN(xq + out)`` with both
  roundings to xq's dtype that the callers' add takes (BERT's
  ``hriemo/frontends/bert.py:80-81``, the fusion layers'
  ``hriemo/models/cross_modal_block_tacfn.py:74,93``).

x is bf16 or fp32: the residual, the LayerNorm and the output follow its
dtype, as the TPU kernels store ``x.dtype``, while q/k/v, the position bias
and the attention core stay bf16, as the TPU kernel casts them
(``hriemo/ops/attention_block.py:208-213``, ``:449``).

On the card the WavLM sublayer's fused route is three launches: the q/k/v
projection that quantizes x's rows itself (``csrc/proj_int8.cu``: a
thread-block cluster spans the 3D bf16 output columns of 64 rows), the
gated core (:func:`attention_core_int8`, ``csrc/attention.cu``: the wgmma
warpgroups of ``csrc/onepass_wgmma.cuh`` from 65 keys, its score panel
below, :func:`core_kernel`), and the out-projection that
quantizes ctx itself with the residual and the LayerNorm in its epilogue
(the cluster exchanges the rows' sums), so neither int8 x, int8 ctx, their
scales nor the fp32 y reach device memory. The MHA sublayer's fused route is
the same three launches, four for cross-attention (q from xq, k/v from
xkv), with the ungated core (the panel or the wgmma warpgroups by
:func:`core_kernel`) and an
out-projection that stores xq's dtype or, with the caller's LayerNorm, adds
the residual in xq's dtype before the norm. Their chain
routes, taken on thin grids (:func:`attention_route`, :func:`mha_route`),
are the sequences of launches they replaced: row quantize
(``csrc/quant_gemm.cu``), one int8 GEMM for q/k/v (self) or one for q and
one for k/v (cross) storing bf16 (``csrc/int8_gemm.cuh``, wgmma), the
two-sweep core, row quantize of the context, the out-proj GEMM (with the
residual epilogue for WavLM) and the LayerNorm: for WavLM the
``hr_layernorm`` pass, for the MHA the caller's plain PyTorch one. The TPU
kernel pads rows to 128 and, for
L <= 64, packs several short elements into one tile; that is TPU layout, so
the port runs every element at its true length and holds the
per-element result. What bounds them on the card: the core's per-score
work under its exact-p/l contract and the bytes each block loads (see
``csrc/onepass_wgmma.cuh``),
the projection GEMMs' int8 operations, and the host's launches at short L.
"""

from __future__ import annotations

import collections
import math
from typing import NamedTuple

import torch

from ..core.masking import NEG_INF
from . import _cuda
from .fused_ffn import layer_norm_rows, quant_rows
from .quant import int8_matmul_exact


class MhaOperands(NamedTuple):
    """Packed-MHA kernel operands. q rows of ``s_in``/``b_in`` carry the
    folded 1/sqrt(hd) (``hriemo/ops/attention_block.py:821-824``)."""
    w_in: torch.Tensor   # [3D, D] int8
    s_in: torch.Tensor   # [3D, 1] fp32
    b_in: torch.Tensor   # [3D] fp32
    w_out: torch.Tensor  # [D, D] int8
    s_out: torch.Tensor  # [D, 1] fp32
    b_out: torch.Tensor  # [D] fp32
    n_heads: int


class WavLMAttnOperands(NamedTuple):
    mha: MhaOperands     # q/k/v packed as an in_proj
    wg: torch.Tensor     # [8, hd] gate Linear weight: bf16 values, stored fp32
    bg: torch.Tensor     # [8] fp32
    gconst: torch.Tensor  # [H] fp32
    ln_w: torch.Tensor   # [D] fp32
    ln_b: torch.Tensor   # [D] fp32


def mha_operands(w_in, s_in, b_in, out_proj, n_heads: int) -> MhaOperands:
    """``w_in`` [3D, D] int8, ``s_in`` [3D, 1], ``b_in`` [3D] or None (any
    float dtype), ``out_proj`` a quantized ``nn.layers.Linear``."""
    d = w_in.shape[1]
    scale = 1.0 / math.sqrt(d // n_heads)
    s = s_in.detach().float().clone()
    b = (torch.zeros(3 * d, device=w_in.device) if b_in is None
         else b_in.detach().float().clone())
    s[:d] = s[:d] * scale
    b[:d] = b[:d] * scale
    b_out = (torch.zeros(d, device=w_in.device) if out_proj.bias is None
             else out_proj.bias.detach().float())
    return MhaOperands(w_in, s, b, out_proj.w_int8, out_proj.w_scale, b_out, n_heads)


def wavlm_attn_operands(attn, ln) -> WavLMAttnOperands:
    """From a quantized ``frontends.wavlm.WavLMAttention`` and its
    post-attention ``LayerNorm``. The gate weight is rounded to bf16, as the
    TPU kernel's (``hriemo/ops/attention_block.py:464``); on bf16 trees it
    is bf16 already."""
    def cat(name):
        ts = [getattr(getattr(attn, p), name) for p in ("q_proj", "k_proj", "v_proj")]
        return torch.cat(ts, 0)
    h = attn.n_heads
    mha = mha_operands(cat("w_int8"), cat("w_scale"), cat("bias"), attn.out_proj, h)
    g = attn.gru_rel_pos_linear
    return WavLMAttnOperands(mha, g.weight.detach().to(torch.bfloat16).float(),
                             g.bias.detach().float(),
                             attn.gru_rel_pos_const.detach().float().reshape(h),
                             ln.weight.detach().float(), ln.bias.detach().float())


def softmax_pv(s, v):
    """fp32 softmax of ``s``, ``p / l`` cast to v's dtype, PV summed in fp32,
    result in v's dtype: the one-pass softmax of every attention kernel."""
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    return ((p / l).to(v.dtype).float() @ v.float()).to(v.dtype)


def _heads(t, b, l, h):
    """``[B*L, H*hd]`` -> ``[B, H, L, hd]``."""
    return t.reshape(b, l, h, -1).transpose(1, 2)


def _merge(t):
    b, h, l, hd = t.shape
    return t.transpose(1, 2).reshape(b * l, h * hd)


def _gate(x, wg, bg, gconst, b, lq, h):
    """WavLM's gate ``[B, H, Lq, 1]`` from the sublayer input ``x [B*Lq,
    D]``; the gate GEMM reads x as bf16, as the TPU kernel's
    ``x.astype(wg.dtype)``."""
    g = x.to(torch.bfloat16).float().reshape(b, lq, h, -1) @ wg.t() + bg
    ga = torch.sigmoid(g[..., 0:4].sum(-1))
    gb = torch.sigmoid(g[..., 4:8].sum(-1))
    return (ga * (gb * gconst - 1.0) + 2.0).transpose(1, 2)[..., None]


def attention_core_int8_plain(q, k, v, b: int, n_heads: int, kbias=None, kpm=None, gate=None):
    """Plain PyTorch version of :func:`attention_core_int8`: fp32 scores,
    ``+ gate * pos``, ``+ kbias`` or the padding mask's NEG_INF, then
    :func:`softmax_pv`."""
    lq, lk, h = q.shape[0] // b, k.shape[0] // b, n_heads
    s = _heads(q, b, lq, h).float() @ _heads(k, b, lk, h).float().transpose(-1, -2)
    if gate is not None:
        x, wg, bg, gconst, pos = gate
        s = s + _gate(x, wg, bg, gconst, b, lq, h) * pos.float()[None]
    if kbias is not None:
        s = s + kbias[:, None, None, :]
    if kpm is not None:
        s = s + torch.where(kpm, NEG_INF, 0.0)[:, None, None, :]
    return _merge(softmax_pv(s, _heads(v, b, lk, h)))


def _rows(t, name, rows, cols, dev, dtypes=(torch.bfloat16,)):
    """A ``[rows, cols]`` kernel operand of one of ``dtypes`` read in place,
    rows possibly further apart than ``cols`` (a column block of a packed
    projection): returns ``(data pointer, row stride)``."""
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel needs one of {dtypes}")
    if tuple(t.shape) != (rows, cols) or t.device != dev:
        raise ValueError(f"{name}: {tuple(t.shape)} on {t.device}, kernel needs "
                         f"{(rows, cols)} on {dev}")
    if t.stride(1) != 1 or (t.stride(0) * t.element_size()) % 16 or t.data_ptr() % 16:
        raise ValueError(f"{name}: rows must be contiguous and 16-byte aligned")
    return t.data_ptr(), t.stride(0)


# The core's kernels at head dims 64 and 96 (csrc/attention.cu CoreKernel,
# by the code hr_attention_core takes): the two sweeps of
# onepass_mma_kernel (csrc/onepass_mma.cuh, any key length), the score
# panel (onepass_panel_kernel, up to PANEL_CAP_KEYS keys) and the wgmma
# warpgroups (onepass_wgmma_kernel, csrc/onepass_wgmma.cuh, up to
# WGMMA_CAP_KEYS). Every other head dim runs on the two sweeps' tile
# instances (or, gated, the CUDA-core kernel).
CORE_KERNELS = ("sweeps", "panel", "wgmma")
CORE_HEAD_DIMS = (64, 96)
PANEL_CAP_KEYS = 512
WGMMA_CAP_KEYS = 512
# The rule between them, from chip_proj_routes.py --cores on the H100 (80GB
# HBM3, 700 W; PERF.md section 6), ms at the served batches, the wgmma core
# against the better of the other two:
# - gated (WavLM, 12 x 64): the panel only for one key tile (62 keys: 0.2053
#   against 0.2287, where one consumer warpgroup has no tile); the wgmma core
#   from 65 keys (93: 0.3027 against the panel's 0.3577; 156: 0.2616 against
#   the sweeps' 0.3899; 499: 0.2728 against 0.5121), and at B = 1 and 4;
# - ungated (8 x 96): the panel up to PANEL_MAX_KEYS_UNGATED keys at the
#   served batches (62-187 keys: 0.0664-0.1250 against 0.0965-0.1291;
#   281-312: 0.1759-0.1792 against 0.1992-0.2003, where five tiles leave the
#   consumers unequal and hd 96 spills on the four-tile instance), except four
#   key tiles (193-256: 218 keys 0.0984 against 0.1184, two tiles a
#   consumer); the wgmma core past the panel (343: 0.2489 against the sweeps'
#   0.2802) and below PANEL_MIN_BATCH elements (B = 1 and 4 at 187 keys:
#   0.0064 / 0.0069 against 0.0097 / 0.0102), except one key tile.
PANEL_MAX_KEYS = 64
PANEL_MAX_KEYS_UNGATED = 320
PANEL_MIN_BATCH = 16
# How much slower than the fastest of the three the rule's kernel may read
# at a served shape: gated 124 keys at B=192 read 0.2853 against the
# panel's 0.2796 ms (2.0%), and one kernel's reading moves by up to 2%
# between calls on the card.
CORE_ROUTE_MARGIN = 0.05


def core_kernel(lk: int, gated: bool, hd: int = 64, b: int = 1) -> str:
    """The kernel of :data:`CORE_KERNELS` that a core of ``b`` elements of
    ``lk`` keys at head dim ``hd``, gated or not, takes: "sweeps" past
    :data:`WGMMA_CAP_KEYS` keys and at head dims other than
    :data:`CORE_HEAD_DIMS`; "panel" up to :data:`PANEL_MAX_KEYS` keys (one
    key tile), and without the gate up to :data:`PANEL_MAX_KEYS_UNGATED`
    from :data:`PANEL_MIN_BATCH` elements, except four key tiles (193-256
    keys); else "wgmma"."""
    if hd not in CORE_HEAD_DIMS or lk > WGMMA_CAP_KEYS:
        return "sweeps"
    if lk <= PANEL_MAX_KEYS:
        return "panel"
    if gated or lk > PANEL_MAX_KEYS_UNGATED or b < PANEL_MIN_BATCH or 192 < lk <= 256:
        return "wgmma"
    return "panel"


def attention_core_int8(q, k, v, b: int, n_heads: int, kbias=None, kpm=None, gate=None,
                        kernel: str | None = None):
    """The int8 sublayers' attention core: ``softmax(q k^T [+ gate * pos] +
    key bias) v`` per head, fp32 scores, ``p / l`` rounded to bf16 before
    PV. ``q [B*Lq, D]``, ``k``/``v [B*Lk, D]`` bf16, each row contiguous (a
    column block of the packed projection is read in place), 1/sqrt(hd)
    already in q; ``kbias [B, Lk]`` fp32 additive or ``kpm [B, Lk]`` bool
    (True = PAD) or neither; ``gate = (x [B*Lq, D] bf16 or fp32, read as
    bf16, wg [8, hd], bg [8], gconst [H], pos [H, Lq, Lk] bf16)`` for
    WavLM's gated position bias. Returns ``ctx [B*Lq, D]`` bf16.
    ``attention_core_int8.launches`` counts its launches, ``.shapes`` the
    same by ``(B, Lq, Lk, H, hd)``, ``.kernels`` by ``(kernel, gated)``,
    the kernel asked for at head dims 64 and 96.

    On the CPU the plain version runs; on the card one launch of
    ``csrc/attention.cu`` (tensor cores at every head dim without the gate,
    at 64 and 96 with it), or a raise. ``kernel``: one of
    :data:`CORE_KERNELS` at head dims 64 and 96 (other head dims take only
    "sweeps"); None: :func:`core_kernel`.
    """
    if q.device.type == "cpu":
        return attention_core_int8_plain(q, k, v, b, n_heads, kbias, kpm, gate)
    d, h, dev = q.shape[1], n_heads, q.device
    lq, lk = q.shape[0] // b, k.shape[0] // b
    hd = d // h
    if hd * h != d or hd % 8 or hd > 256:
        raise ValueError(f"attention kernel: unsupported width d={d}, heads={h}")
    if lk > 1024:
        raise ValueError(f"attention kernel: key length {lk} > 1024")
    if kbias is not None and kpm is not None:
        raise ValueError("attention kernel: give kbias or kpm, not both")
    if kernel is None:
        kernel = core_kernel(lk, gate is not None, hd, b)
    if kernel not in CORE_KERNELS:
        raise ValueError(f"attention kernel: unknown core {kernel!r}")
    cap = {"panel": PANEL_CAP_KEYS, "wgmma": WGMMA_CAP_KEYS}.get(kernel)
    if cap is not None and (lk > cap or hd not in CORE_HEAD_DIMS):
        raise ValueError(f"attention kernel: no {kernel} core holds {lk} keys at head dim {hd}")
    args = [*_rows(q, "q", b * lq, d, dev), *_rows(k, "k", b * lk, d, dev),
            *_rows(v, "v", b * lk, d, dev), b, lq, lk, h, hd]
    if kbias is not None:
        _cuda.require(kbias, "kbias", torch.float32, (b, lk), dev)
    if kpm is not None:
        _cuda.require(kpm, "key_padding_mask", torch.bool, (b, lk), dev)
    args += [_cuda.ptr(kbias), _cuda.ptr(kpm)]
    if gate is not None:
        x, wg, bg, gconst, pos = gate
        _cuda.require(wg, "wg", torch.float32, (8, hd), dev)
        _cuda.require(bg, "bg", torch.float32, (8,), dev)
        _cuda.require(gconst, "gconst", torch.float32, (h,), dev)
        _cuda.require(pos, "pos", torch.bfloat16, (h, lq, lk), dev)
        args += [*_rows(x, "x", b * lq, d, dev, _cuda.ACT_DTYPES),
                 int(x.dtype == torch.float32), wg.data_ptr(), bg.data_ptr(),
                 gconst.data_ptr(), pos.data_ptr()]
    else:
        args += [None, 0, 0, None, None, None, None]
    ctx = torch.empty((b * lq, d), dtype=torch.bfloat16, device=dev)
    _cuda.check(_cuda.lib("attention").hr_attention_core(
        *args, ctx.data_ptr(), d, CORE_KERNELS.index(kernel), _cuda.stream()),
        "hr_attention_core")
    attention_core_int8.launches += 1
    attention_core_int8.shapes[(b, lq, lk, h, hd)] += 1
    if hd in CORE_HEAD_DIMS:
        attention_core_int8.kernels[(kernel, gate is not None)] += 1
    return ctx


attention_core_int8.launches = 0
attention_core_int8.shapes = collections.Counter()  # by (B, Lq, Lk, H, hd)
attention_core_int8.kernels = collections.Counter()  # by (kernel, gated) at hd 64 and 96


def attention_block_int8_plain(x, ops: WavLMAttnOperands, pos, kbias, eps: float):
    """Plain PyTorch version of :func:`attention_block_int8`."""
    b, l, d = x.shape
    m, h = ops.mha, ops.mha.n_heads
    x2 = x.reshape(b * l, d)
    pos = pos.to(torch.bfloat16)
    xq, xs = quant_rows(x2.float())
    qkv = (int8_matmul_exact(xq, m.w_in) * xs * m.s_in[:, 0] + m.b_in).to(torch.bfloat16)
    q, k, v = qkv.split(d, dim=1)
    ctx = attention_core_int8_plain(q, k, v, b, h, kbias=kbias,
                                    gate=(x2, ops.wg, ops.bg, ops.gconst, pos))
    cq, cs = quant_rows(ctx.float())
    y = int8_matmul_exact(cq, m.w_out) * cs * m.s_out[:, 0] + m.b_out
    y = y + x2.float()
    return layer_norm_rows(y, ops.ln_w, ops.ln_b, eps).to(x.dtype).reshape(b, l, d)


def _check_mha(ops: MhaOperands, d: int, dev):
    _cuda.require(ops.w_in, "w_in", torch.int8, (3 * d, d), dev)
    _cuda.require(ops.s_in, "s_in", torch.float32, (3 * d, 1), dev)
    _cuda.require(ops.b_in, "b_in", torch.float32, (3 * d,), dev)
    _cuda.require(ops.w_out, "w_out", torch.int8, (d, d), dev)
    _cuda.require(ops.s_out, "s_out", torch.float32, (d, 1), dev)
    _cuda.require(ops.b_out, "b_out", torch.float32, (d,), dev)


# Waves of the out-projection's cluster grid from which the sublayer's fused
# route beats the chain (chip_proj_routes.py, H100 80GB HBM3 at 700 W,
# PERF.md section 6): 0.0704 against 0.0737 ms at 32 x 62 rows (0.48
# waves of 2 x 384), 0.1166 against 0.1186 at 4 x 499; 0.0518 against
# 0.0429 at 4 x 124 (0.12 waves). The out-projection with the LayerNorm
# saves the most (0.136 against 0.239 ms at 23,808 rows), the panel core
# at up to 128 keys the next; the q/k/v projection stays within 2-4% of its
# chain's two launches.
ATTN_MIN_WAVES = 0.4


def attention_route(m: int, d: int, x_bytes: int = 2, sms: int = _cuda.H100_SMS) -> str:
    """The WavLM sublayer's route at ``m`` rows of width ``d``: "fused" where
    a projection cluster spans both its products (q/k/v, ``3d`` bf16
    columns; the out-projection, ``d`` columns in x's dtype) and the
    out-projection's grid covers the card :data:`ATTN_MIN_WAVES` times,
    else "chain"."""
    cl = _cuda.proj_cluster(d, d, x_bytes)
    if cl is None or _cuda.proj_cluster(3 * d, d, 2) is None:
        return "chain"
    return "fused" if -(-m // 64) * cl[1] / sms >= ATTN_MIN_WAVES else "chain"


def attention_block_int8(x, ops: WavLMAttnOperands, pos, kbias, eps: float,
                         route: str | None = None):
    """WavLM attention sublayer: ``x [B, L, D]`` bf16 or fp32 -> ``LN(x +
    attn(x))`` in x's dtype.

    ``pos`` [H, L, L] is the shared position bias, rounded to bf16 as the
    TPU wrapper stores it; ``kbias`` [B, L] fp32 the additive key-padding
    bias (0 valid / NEG_INF pad).

    On the CPU the plain version runs, whatever ``route``. On the card,
    "fused" is three launches: the q/k/v projection quantizing x's rows
    itself (``_cuda.proj_gemm``), the gated core (on the kernel
    :func:`core_kernel` picks), the out-projection quantizing ctx with the
    residual and the LayerNorm in its epilogue (``_cuda.proj_gemm_ln``);
    "chain" the six launches it replaced (row quantize, q/k/v GEMM, the
    two-sweep core, row quantize, out GEMM, LayerNorm); None lets
    :func:`attention_route` choose by rows. ``.routes`` counts calls by
    route, ``.shapes`` by (route, B, L, D, x's element bytes).
    """
    b, l, d = x.shape
    if kbias.shape[0] != b:
        # the reference rejects a mis-batched bias (attention_block.py:427-431)
        raise ValueError(f"key_padding_bias batch {kbias.shape[0]} != x batch {b}")
    if x.device.type == "cpu":
        return attention_block_int8_plain(x, ops, pos, kbias, eps)
    m, h = ops.mha, ops.mha.n_heads
    dev = x.device
    _cuda.require(x, "x", _cuda.ACT_DTYPES)
    _check_mha(m, d, dev)
    _cuda.require(ops.ln_w, "ln_w", torch.float32, (d,), dev)
    _cuda.require(ops.ln_b, "ln_b", torch.float32, (d,), dev)
    x2 = x.view(b * l, d)
    pos = pos.to(torch.bfloat16)
    gate = (x2, ops.wg, ops.bg, ops.gconst, pos)
    if route is None:
        route = attention_route(b * l, d, x.element_size(), _cuda.sm_count())
    if route == "fused":
        qkv = _cuda.proj_gemm(x2, m.w_in, m.s_in, m.b_in, _cuda.EPI_BF16, div127=False)
        q, k, v = qkv.split(d, dim=1)
        ctx = attention_core_int8(q, k, v, b, h, kbias=kbias, gate=gate)
        out = _cuda.proj_gemm_ln(ctx, m.w_out, m.s_out, m.b_out, x2, ops.ln_w, ops.ln_b, eps)
    elif route == "chain":
        xq, xs = _cuda.rowquant(x2, div127=False)
        qkv = _cuda.int8_gemm(xq, xs, m.w_in, m.s_in, m.b_in, _cuda.EPI_BF16)
        q, k, v = qkv.split(d, dim=1)
        ctx = attention_core_int8(q, k, v, b, h, kbias=kbias, gate=gate, kernel="sweeps")
        cq, cs = _cuda.rowquant(ctx, div127=False)
        y = _cuda.int8_gemm(cq, cs, m.w_out, m.s_out, m.b_out, _cuda.EPI_RESID_LAST,
                            resid=x2)
        out = _cuda.layernorm(y, ops.ln_w, ops.ln_b, eps, x.dtype)
    else:
        raise ValueError(f"W8A8 attention sublayer: unknown route {route!r}")
    attention_block_int8.launches += 1
    attention_block_int8.routes[route] += 1
    attention_block_int8.shapes[route, b, l, d, x.element_size()] += 1
    return out.view(b, l, d)


attention_block_int8.launches = 0
attention_block_int8.routes = collections.Counter()
attention_block_int8.shapes = collections.Counter()  # by (route, B, L, D, x bytes)


def _add_norm(xq, y, norm):
    """The callers' ``layer_norm(xq + y)``: the add in xq's dtype, fp32
    statistics, the result in xq's dtype (``nn.layers.layer_norm``)."""
    ln_w, ln_b, eps = norm
    return layer_norm_rows((xq + y).float(), ln_w, ln_b, eps).to(xq.dtype)


def mha_block_int8_plain(xq, xkv, ops: MhaOperands, key_padding_mask, norm=None):
    """Plain PyTorch version of :func:`mha_block_int8`."""
    b, lq, d = xq.shape
    lk = xkv.shape[1]
    h = ops.n_heads
    aq, aqs = quant_rows(xq.reshape(b * lq, d).float())
    ak, aks = quant_rows(xkv.reshape(b * lk, d).float())
    w, s, bias = ops.w_in, ops.s_in[:, 0], ops.b_in
    q = (int8_matmul_exact(aq, w[:d]) * aqs * s[:d] + bias[:d]).to(torch.bfloat16)
    kv = (int8_matmul_exact(ak, w[d:]) * aks * s[d:] + bias[d:]).to(torch.bfloat16)
    k, v = kv.split(d, dim=1)
    ctx = attention_core_int8_plain(q, k, v, b, h, kpm=key_padding_mask)
    cq, cs = quant_rows(ctx.float())
    y = int8_matmul_exact(cq, ops.w_out) * cs * ops.s_out[:, 0] + ops.b_out
    y = y.to(xq.dtype).reshape(b, lq, d)
    return y if norm is None else _add_norm(xq, y, norm)


# Waves of the out-projection's cluster grid from which the MHA sublayer's
# fused route beats the chain without the caller's LayerNorm
# (chip_proj_routes.py --mha-routes, H100 80GB HBM3 at 700 W, PERF.md
# section 6): below, one fused launch's fixed cost loses (audio -> text
# 0.0557 against 0.0444 ms at 0.47 waves); above, fused wins by up to 20%
# (BERT self 0.1032 against 0.1285 at 0.73 waves, audio -> text 0.0648
# against 0.0763 at 0.94) or loses by at most 5% where the q/k/v
# projection's 3-6% over its chain is not made up (10 s BERT self 0.1009
# against 0.0962 at 0.97 waves).
MHA_STORE_MIN_WAVES = 0.6
# With the caller's LayerNorm, the two routes' launches other than the core
# estimated from card readings at K = 768, scaled with K
# (chip_proj_routes.py --mha-model, H100 80GB HBM3 at 700 W, PERF.md
# section 6). A projection that quantizes its own rows takes
# PROJ_FIRST_WAVE_MS plus PROJ_WAVE_MS[config] for each wave of the
# clusters the card runs at once (_cuda.proj_clusters): k/v over 1,920 rows
# (30 clusters of 4 blocks, as many as the card holds) 0.0157 ms, over
# 1,984 (31) 0.0280, over 3,968 (62) 0.0419; the out-projection with the
# LayerNorm PROJ_LN_WAVE_MS a wave (0.0211-0.0237 up to 4,096 rows). The
# chain's row quantize and GEMM take CHAIN_PROJ_MS[0] or, where more,
# CHAIN_PROJ_MS[1] plus their int8 operations at CHAIN_PROJ_MS[2] a ms (k/v
# 0.0087 at 64 rows, 0.0211 at 1,984, 0.0767 at 8,192); the caller's plain
# LayerNorm PLAIN_LN_MS[0] plus PLAIN_LN_MS[1] an element, or
# PLAIN_LN_MS[2] an element where more (0.0258 at 64 x 768, 0.0897 at
# 4,096 x 768). The fused route saves the LayerNorm's launches but pays a
# fused projection's fixed time at any rows: cross-attention from a few
# query rows to keys whose k/v grid spills into a second wave is no faster
# fused (B=4 16 x 499: 0.0914 against 0.0921 ms; another card read 0.0941
# against 0.0882), so the fused route must be estimated
# MHA_FUSED_MARGIN_MS faster, about the estimate's error at such shapes.
# Where the core takes the score panel or the wgmma core, which the chain
# (on the two sweeps) never does, the fused route is taken: with the panel it
# was the faster at every rung of the ladder (--mha-routes: at most 0.974 of
# the chain's time over 117 rungs).
PROJ_FIRST_WAVE_MS = 0.0015
PROJ_WAVE_MS = (0.0138, 0.0172)
PROJ_LN_WAVE_MS = 0.0215
CHAIN_PROJ_MS = (0.0085, 0.003, 2.6e11)
PLAIN_LN_MS = (0.025, 1.5e-8, 2.9e-8)
MHA_FUSED_MARGIN_MS = 0.002


def _proj_ms(n: int, m: int, k: int, fused: bool, sms: int) -> float:
    """Estimated ms of a projection of ``m`` rows over ``k`` inputs to ``n``
    bf16 columns: :func:`_cuda.proj_gemm` (``fused``) or the chain's row
    quantize and int8 GEMM."""
    if not fused:
        return max(CHAIN_PROJ_MS[0], CHAIN_PROJ_MS[1] + 2 * m * n * k / CHAIN_PROJ_MS[2])
    config, _ = _cuda.proj_block(n, m, k, 2, sms)
    return (PROJ_FIRST_WAVE_MS + _waves(m, n, k, config, sms) * PROJ_WAVE_MS[config]) * k / 768


def _waves(m: int, n: int, k: int, config: int, sms: int) -> int:
    """Waves of a projection's grid of ``m`` rows (a cluster for each 64)
    over the clusters the card runs at once."""
    return -(-(-(-m // 64)) // _cuda.proj_clusters(n, k, config, sms))


def mha_route(b: int, lq: int, lk: int, d: int, heads: int, x_bytes: int = 2,
              norm: bool = True, cross: bool = False, sms: int = _cuda.H100_SMS) -> str:
    """The MHA sublayer's route at batch ``b``, ``lq`` queries and ``lk``
    keys of width ``d`` in ``heads`` heads: "chain" where no projection
    cluster spans a product (q/k/v, ``3d`` bf16 columns; for
    cross-attention q, ``d``, and k/v, ``2d``; the out-projection, ``d``
    columns in x's dtype). Else, without the caller's LayerNorm, "fused"
    where the out-projection's grid covers the card
    :data:`MHA_STORE_MIN_WAVES` times; with it, "fused" where the core takes
    a kernel other than the two sweeps (:func:`core_kernel`) or the fused
    projections' estimated
    time (:func:`_proj_ms`, the out-projection with the LayerNorm) is
    :data:`MHA_FUSED_MARGIN_MS` below the chain's with the plain LayerNorm."""
    m = b * lq
    cl = _cuda.proj_cluster(d, d, x_bytes)
    ins = ((d, m), (2 * d, b * lk)) if cross else ((3 * d, m),)
    if cl is None or any(_cuda.proj_cluster(n, d, 2) is None for n, _ in ins):
        return "chain"
    if not norm:
        return "fused" if -(-m // 64) * cl[1] / sms >= MHA_STORE_MIN_WAVES else "chain"
    if core_kernel(lk, False, d // heads, b) != "sweeps":
        return "fused"
    fused = sum(_proj_ms(n, r, d, True, sms) for n, r in ins) \
        + _waves(m, d, d, cl[0], sms) * PROJ_LN_WAVE_MS * d / 768
    chain = sum(_proj_ms(n, r, d, False, sms) for n, r in ins) + _proj_ms(d, m, d, False, sms) \
        + max(PLAIN_LN_MS[0] + PLAIN_LN_MS[1] * m * d, PLAIN_LN_MS[2] * m * d)
    return "fused" if fused < chain - MHA_FUSED_MARGIN_MS else "chain"


def mha_block_int8(xq, xkv, ops: MhaOperands, key_padding_mask, norm=None,
                   route: str | None = None):
    """Fused int8 MHA sublayer: ``xq [B, Lq, D]``, ``xkv [B, Lk, D]``,
    ``key_padding_mask [B, Lk]`` bool True = PAD or None. Returns the
    pre-residual output ``[B, Lq, D]`` in xq's dtype or, with ``norm =
    (ln_w, ln_b, eps)``, the caller's post-norm ``LN(xq + out)`` (the add in
    xq's dtype, fp32 statistics; on the card ``ln_w`` and ``ln_b`` are fp32,
    as ``nn.layers.LayerNorm.norm`` hands them out). Self-attention (``xkv
    is xq``) quantizes once and runs one q/k/v product.

    On the CPU the plain version runs, whatever ``route``. On the card,
    "fused" is three launches for self-attention, four for cross: the
    projections quantizing their rows themselves (``_cuda.proj_gemm``; q
    and k/v from row blocks of ``w_in``), the core (on the kernel
    :func:`core_kernel` picks), and the
    out-projection quantizing ctx, storing xq's dtype or taking the
    residual and the LayerNorm in its epilogue (``_cuda.proj_gemm_ln``,
    ``rounded``); "chain" the launches it replaced (row quantize of xq and
    of xkv, the q/k/v GEMM or the q and k/v GEMMs, the two-sweep core, row
    quantize of ctx, the out GEMM), then the caller's plain LayerNorm; None
    lets :func:`mha_route` choose by rows. ``.routes`` counts calls by
    route, ``.shapes`` by (route, B, Lq, Lk, D, heads, x's element bytes,
    with the LayerNorm, cross-attention).
    """
    if xq.device.type == "cpu":
        return mha_block_int8_plain(xq, xkv, ops, key_padding_mask, norm)
    b, lq, d = xq.shape
    lk = xkv.shape[1]
    h = ops.n_heads
    dev = xq.device
    _cuda.require(xq, "xq", _cuda.ACT_DTYPES)
    _cuda.require(xkv, "xkv", xq.dtype, (b, lk, d), dev)
    _check_mha(ops, d, dev)
    self_attn = xkv is xq
    if norm is not None:
        _cuda.require(norm[0], "ln_w", torch.float32, (d,), dev)
        _cuda.require(norm[1], "ln_b", torch.float32, (d,), dev)
    if route is None:
        route = mha_route(b, lq, lk, d, h, xq.element_size(), norm is not None, not self_attn,
                          _cuda.sm_count())
    x2, kv2 = xq.view(b * lq, d), xkv.view(b * lk, d)
    if route == "fused":
        if self_attn:
            qkv = _cuda.proj_gemm(x2, ops.w_in, ops.s_in, ops.b_in, _cuda.EPI_BF16, div127=False)
            q, k, v = qkv.split(d, dim=1)
        else:
            q = _cuda.proj_gemm(x2, ops.w_in[:d], ops.s_in[:d], ops.b_in[:d], _cuda.EPI_BF16,
                                div127=False)
            kv = _cuda.proj_gemm(kv2, ops.w_in[d:], ops.s_in[d:], ops.b_in[d:], _cuda.EPI_BF16,
                                 div127=False)
            k, v = kv.split(d, dim=1)
        ctx = attention_core_int8(q, k, v, b, h, kpm=key_padding_mask)
        if norm is None:
            out = _cuda.proj_gemm(ctx, ops.w_out, ops.s_out, ops.b_out, _cuda.out_epi(xq.dtype),
                                  div127=False)
        else:
            out = _cuda.proj_gemm_ln(ctx, ops.w_out, ops.s_out, ops.b_out, x2, norm[0], norm[1],
                                     norm[2], rounded=True)
        out = out.view(b, lq, d)
    elif route == "chain":
        aq, aqs = _cuda.rowquant(x2, div127=False)
        if self_attn:
            qkv = _cuda.int8_gemm(aq, aqs, ops.w_in, ops.s_in, ops.b_in, _cuda.EPI_BF16)
            q, k, v = qkv.split(d, dim=1)
        else:
            ak, aks = _cuda.rowquant(kv2, div127=False)
            q = _cuda.int8_gemm(aq, aqs, ops.w_in, ops.s_in, ops.b_in, _cuda.EPI_BF16,
                                w_rows=(0, d))
            kv = _cuda.int8_gemm(ak, aks, ops.w_in, ops.s_in, ops.b_in, _cuda.EPI_BF16,
                                 w_rows=(d, 2 * d))
            k, v = kv.split(d, dim=1)
        ctx = attention_core_int8(q, k, v, b, h, kpm=key_padding_mask, kernel="sweeps")
        cq, cs = _cuda.rowquant(ctx, div127=False)
        out = _cuda.int8_gemm(cq, cs, ops.w_out, ops.s_out, ops.b_out,
                              _cuda.out_epi(xq.dtype)).view(b, lq, d)
        if norm is not None:
            out = _add_norm(xq, out, norm)
    else:
        raise ValueError(f"W8A8 MHA sublayer: unknown route {route!r}")
    mha_block_int8.launches += 1
    mha_block_int8.routes[route] += 1
    mha_block_int8.shapes[route, b, lq, lk, d, h, xq.element_size(), norm is not None,
                          not self_attn] += 1
    return out


mha_block_int8.launches = 0
mha_block_int8.routes = collections.Counter()
# by (route, B, Lq, Lk, D, heads, x bytes, with the LayerNorm, cross-attention)
mha_block_int8.shapes = collections.Counter()


def use_mha_block(quantized: bool, lq: int, lk: int, d: int, n_heads: int) -> bool:
    """``hriemo/ops/attention_block.py::use_mha_block`` without the device
    test: int8 packed params and shapes the TPU kernel takes. Its
    ``8 <= lq`` keeps the decoder's 4-query attention per-op."""
    return (quantized and d % 128 == 0 and (d // n_heads) % 8 == 0
            and 8 <= lq <= 1024 and 8 <= lk <= 1024)


def use_attention_block(quantized: bool, l: int, d: int) -> bool:
    """``hriemo/ops/attention_block.py::use_attention_block`` without the
    device test."""
    return quantized and d % 128 == 0 and 48 <= l <= 1024
