"""W8A8 FFN blocks (port of ``hriemo/ops/fused_ffn.py``).

Two Hopper kernels, each with its plain PyTorch version beside it:

* :func:`ffn_block_int8` replaces the Pallas kernel ``_kernel_int8``
  (``hriemo/ops/fused_ffn.py:94``): ``y = LN(x + W2 gelu(W1 x + b1) + b2)``
  (tanh GELU when ``fast_gelu``, the serving setting, else the erf form)
  with dynamic per-row int8 scales on x and on the fp32 GELU output, int32
  accumulation, per-column weight scales, fp32 residual and LayerNorm. It
  carries the WavLM and BERT FFN blocks.
* :func:`mlp2_int8` replaces ``_kernel_mlp2_int8`` (``:71``): W8A8
  ``Linear -> ReLU -> Linear`` with no LayerNorm; widths may be
  rectangular (the beta gate is 3072 -> 256 -> 768). It carries the fusion
  FFNs and the beta-gate MLP.

On the card each wrapper takes one of two routes, chosen from the shape
(``_cuda.ffn_route``; ``route="tma"`` or ``"chain"`` forces one):

* ``"tma"`` (``csrc/ffn_tma.cu``, three launches): x's row quantize (one
  warp a row), then two persistent, warp-specialised products fed by TMA.
  The first spans all F hidden columns of its 64-row tiles with a
  thread-block cluster (16 x 192 at F=3072), each block keeping its slice
  of W1 in shared memory; two consumer sets take the tiles in turn, so one
  set's epilogue (bias, activation, the row maximum over the cluster by
  asynchronous stores into every block, the requantize) overlaps the other
  set's products; ``hq``, ``hs`` are the chain's bits. The second takes
  128-row tiles of hq and, for the FFN, adds the residual and takes the
  LayerNorm over a cluster spanning the 768 outputs (6 x 128; its sums in
  another order than the LayerNorm pass: held to the plain version's
  tolerance); for mlp2 it stores the chain's bits. Neither the fp32 h nor
  the fp32 y reaches device memory. The weights' tensor maps are encoded
  once a weight (``_cuda.ffn_tma_wmap``). The beta gate's 3072 inputs (W1's
  slice does not fit shared memory) and widths no power-of-two cluster
  spans take the chain.
* ``"chain"``: row quantize, int8 GEMM with an fp32 [M, F] output, row
  quantize of h, the second GEMM (and the LayerNorm): five launches for the
  FFN, four for mlp2.

x is bf16 or fp32, and the residual read and the output follow its dtype,
as the TPU kernels store ``x.dtype``. What bounds the pair: int8
tensor-core operations (the two products are 4*M*768*3072 at the main
path's widths, against ~2.4 MB of weights); the chain also writes and reads
back the fp32 h, 24.5 MB at M=1996. The TMA route is taken where its first
product's 64-row tiles cover the clusters the card runs at once
``_cuda.TMA_MIN_WAVES`` times: 2 waves for the GELU forms, 0.75 for ReLU,
which at 768 -> 3072 (7 clusters of 16 on an H100) is from 833 rows for
the GELU FFN and 321 for the ReLU pair. Every served WavLM, BERT and
fusion FFN at the measured batches takes it; thinner grids (B=1, phase 4's
text rows, the beta gates) take the chain. The thresholds are the H100's,
measured by ``chip_ffn_routes.py``; ``chip_smoke.py`` phase 3 times each
route beside the other and fails where the chosen one is the slower.
Forcing the TMA route where no block takes the widths raises. Each wrapper
counts its calls by route in ``.routes`` and by (route, rows, inputs,
hidden width, epilogue) in ``.shapes``.

A third kernel, :func:`ffn_block_bf16`, replaces ``_kernel_bf16``
(``:112-124``, ``pallas_call`` at ``:192``): the same block over bf16 or
fp32 x and weights, three launches: the two products as large-tile GEMMs of
``csrc/ffn_bf16.cu`` (bf16 on ``wgmma``, fp32 in 3xTF32; the hidden
activation goes through device memory in x's dtype), then the fp32
LayerNorm pass. Its gradient recomputes through the unfused reference, as
the JAX custom VJP does. The JAX routing never calls it (float FFNs go per
op, ``route_ffn_block``); :func:`use_ffn_bf16` is that gate, False.
"""

from __future__ import annotations

import collections
import math
from typing import NamedTuple

import torch

from . import _cuda
from .quant import int8_matmul_exact


class Mlp2Operands(NamedTuple):
    """Kernel operands of one W8A8 Linear pair: ``[out, in]`` int8 weights,
    fp32 ``[out, 1]`` scales and fp32 biases."""
    w1: torch.Tensor
    s1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    s2: torch.Tensor
    b2: torch.Tensor


class FfnOperands(NamedTuple):
    pair: Mlp2Operands
    ln_w: torch.Tensor  # fp32 LayerNorm weight
    ln_b: torch.Tensor  # fp32 LayerNorm bias


def mlp2_operands(l0, l2) -> Mlp2Operands:
    """From two quantized ``nn.layers.Linear`` modules."""
    return Mlp2Operands(l0.w_int8, l0.w_scale, l0.bias.detach().float(),
                        l2.w_int8, l2.w_scale, l2.bias.detach().float())


def ffn_operands(p_in, p_out, ln) -> FfnOperands:
    return FfnOperands(mlp2_operands(p_in, p_out), ln.weight.detach().float(),
                       ln.bias.detach().float())


def gelu_fp32(x, fast: bool):
    """``hriemo/ops/fused_ffn.py::_gelu`` on fp32, operation for operation:
    the tanh form when ``fast``, else the erf form."""
    if fast:
        return 0.5 * x * (1.0 + torch.tanh(0.7978845608028654 * (x + 0.044715 * x * x * x)))
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def quant_rows(x):
    """The kernels' per-row quantization: ``max(amax, 1e-8) * (1/127)``."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    s = amax.clamp_min(1e-8) * (1.0 / 127.0)
    q = torch.round(x / s).clamp_(-127, 127)
    return q.to(torch.int8), s


def layer_norm_rows(y, w, b, eps):
    """fp32 LayerNorm of the last axis, in the kernels' order."""
    mean = y.mean(dim=-1, keepdim=True)
    var = torch.square(y - mean).mean(dim=-1, keepdim=True)
    return (y - mean) * torch.rsqrt(var + eps) * w + b


def int8_gemm_plain(a, a_scale, w, w_scale, bias, epi: int, resid=None):
    """Plain version of the shared int8 GEMM (``_cuda.int8_gemm``): ``a [M,
    K]`` int8, ``a_scale [M]``, ``w [N, K]`` int8, ``w_scale [N, 1]``,
    ``bias [N]`` or None, ``resid [M, N]`` (bf16 or fp32) for the residual
    epilogues.
    Each step rounds as the kernel's epilogue does, with the erf GELU's
    ``x / sqrt(2)`` an IEEE division (a tensor divisor: PyTorch's CUDA
    division by a Python scalar multiplies by the reciprocal)."""
    v = int8_matmul_exact(a, w) * a_scale[:, None] * w_scale[:, 0]
    vb = v if bias is None else v + bias
    if epi == _cuda.EPI_BF16:
        return vb.to(torch.bfloat16)
    if epi == _cuda.EPI_F32:
        return vb
    if epi == _cuda.EPI_GELU_F32:
        return gelu_fp32(vb, True)
    if epi == _cuda.EPI_GELU_ERF_F32:
        return 0.5 * vb * (1.0 + torch.erf(vb / vb.new_full((), math.sqrt(2.0))))
    if epi == _cuda.EPI_RELU_F32:
        return torch.clamp_min(vb, 0.0)
    if epi == _cuda.EPI_RESID_FIRST:
        y = resid.float() + v
        return y if bias is None else y + bias
    if epi == _cuda.EPI_RESID_LAST:
        return vb + resid.float()
    raise ValueError(f"int8 GEMM: unknown epilogue {epi}")


def ffn_block_int8_plain(x, ops: FfnOperands, eps: float, fast_gelu: bool):
    """Plain PyTorch version of :func:`ffn_block_int8`."""
    p = ops.pair
    xf = x.float()
    xq, xs = quant_rows(xf)
    h = int8_matmul_exact(xq, p.w1) * xs * p.s1[:, 0] + p.b1
    h = gelu_fp32(h, fast_gelu)
    hq, hs = quant_rows(h)
    y = xf + int8_matmul_exact(hq, p.w2) * hs * p.s2[:, 0] + p.b2
    return layer_norm_rows(y, ops.ln_w, ops.ln_b, eps).to(x.dtype)


def _check_pair(x, p: Mlp2Operands):
    f, din = p.w1.shape
    dout = p.w2.shape[0]
    _cuda.require(x, "x", _cuda.ACT_DTYPES, (x.shape[0], din))
    dev = x.device
    _cuda.require(p.w1, "w1", torch.int8, (f, din), dev)
    _cuda.require(p.s1, "s1", torch.float32, (f, 1), dev)
    _cuda.require(p.b1, "b1", torch.float32, (f,), dev)
    _cuda.require(p.w2, "w2", torch.int8, (dout, f), dev)
    _cuda.require(p.s2, "s2", torch.float32, (dout, 1), dev)
    _cuda.require(p.b2, "b2", torch.float32, (dout,), dev)


ROUTES = ("tma", "chain")


def _route(x, p: Mlp2Operands, epi: int, route: str | None) -> str:
    """``route`` as the caller forces it, or as :func:`_cuda.ffn_route`
    chooses it for the shape."""
    if route is None:
        (f, k), n = p.w1.shape, p.w2.shape[0]
        return _cuda.ffn_route(f, x.shape[0], k, epi, _cuda.sm_count(), n=n)
    if route not in ROUTES:
        raise ValueError(f"W8A8 FFN pair: unknown route {route!r}")
    return route


def _tma_pair(x, p: Mlp2Operands, epi: int, norm=None):
    """The TMA route (csrc/ffn_tma.cu): x's row quantize, then the two
    products, the second with the residual and LayerNorm ``norm=(g, b,
    eps)`` or the dequant-and-bias store in x's dtype; three launches."""
    xq, xs = _cuda.ffn_tma_xquant(x)
    hq, hs = _cuda.ffn_tma_gemm1(xq, xs, p.w1, p.s1, p.b1, epi)
    return _cuda.ffn_tma_gemm2(hq, hs, p.w2, p.s2, p.b2, x.dtype,
                               resid=x if norm is not None else None, norm=norm)


def _chain_hidden(x, p: Mlp2Operands, epi: int):
    """The chain's hidden activation: ``(hq, hs)``, int8 rows and scales of
    ``act(W1 . quant_rows(x))`` in three launches."""
    xq, xs = _cuda.rowquant(x, div127=False)
    return _cuda.rowquant(_cuda.int8_gemm(xq, xs, p.w1, p.s1, p.b1, epi), div127=False)


def ffn_block_int8(x, ops: FfnOperands, eps: float, fast_gelu: bool,
                   route: str | None = None):
    """Fused W8A8 FFN block over ``x [M, D]`` bf16 or fp32 -> ``[M, D]`` in
    x's dtype.

    On the CPU the plain version runs, whatever ``route``; on the card three
    launches on the TMA route, the chain's five on the chain (``route``
    "tma" or "chain" forces one, None lets the shape choose; see the module
    docstring), no torch compute in between.
    """
    if x.device.type == "cpu":
        return ffn_block_int8_plain(x, ops, eps, fast_gelu)
    p = ops.pair
    _check_pair(x, p)
    d = x.shape[1]
    _cuda.require(ops.ln_w, "ln_w", torch.float32, (d,), x.device)
    _cuda.require(ops.ln_b, "ln_b", torch.float32, (d,), x.device)
    epi = _cuda.EPI_GELU_F32 if fast_gelu else _cuda.EPI_GELU_ERF_F32
    route = _route(x, p, epi, route)
    if route == "tma":
        out = _tma_pair(x, p, epi, (ops.ln_w, ops.ln_b, eps))
    else:
        hq, hs = _chain_hidden(x, p, epi)
        y = _cuda.int8_gemm(hq, hs, p.w2, p.s2, p.b2, _cuda.EPI_RESID_FIRST, resid=x)
        out = _cuda.layernorm(y, ops.ln_w, ops.ln_b, eps, x.dtype)
    _count(ffn_block_int8, route, x.shape[0], *p.w1.shape, epi)
    return out


def _count(fn, route, m, f, k, epi):
    fn.launches += 1
    fn.routes[route] += 1
    fn.shapes[route, m, k, f, epi] += 1


# calls, by route, and by (route, rows, inputs, hidden width, epilogue)
ffn_block_int8.launches = 0
ffn_block_int8.routes = collections.Counter()
ffn_block_int8.shapes = collections.Counter()


def mlp2_int8_plain(x, ops: Mlp2Operands):
    """Plain PyTorch version of :func:`mlp2_int8`."""
    shape = x.shape
    xf = x.reshape(-1, shape[-1]).float()
    xq, xs = quant_rows(xf)
    h = torch.clamp_min(int8_matmul_exact(xq, ops.w1) * xs * ops.s1[:, 0] + ops.b1, 0.0)
    hq, hs = quant_rows(h)
    y = int8_matmul_exact(hq, ops.w2) * hs * ops.s2[:, 0] + ops.b2
    return y.to(x.dtype).reshape(*shape[:-1], ops.w2.shape[0])


def mlp2_int8(x, ops: Mlp2Operands, route: str | None = None):
    """Fused W8A8 ``Linear -> ReLU -> Linear`` over ``x [..., Din]`` bf16 or
    fp32, output in x's dtype: three launches on the card's TMA route, the
    chain's four on the chain (``route`` as in
    :func:`ffn_block_int8`)."""
    if x.device.type == "cpu":
        return mlp2_int8_plain(x, ops)
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    _check_pair(x2, ops)
    route = _route(x2, ops, _cuda.EPI_RELU_F32, route)
    if route == "tma":
        y = _tma_pair(x2, ops, _cuda.EPI_RELU_F32)
    else:
        hq, hs = _chain_hidden(x2, ops, _cuda.EPI_RELU_F32)
        y = _cuda.int8_gemm(hq, hs, ops.w2, ops.s2, ops.b2, _cuda.out_epi(x.dtype))
    _count(mlp2_int8, route, x2.shape[0], *ops.w1.shape, _cuda.EPI_RELU_F32)
    return y.reshape(*shape[:-1], ops.w2.shape[0])


mlp2_int8.launches = 0
mlp2_int8.routes = collections.Counter()
mlp2_int8.shapes = collections.Counter()


def use_mlp2_int8(l0, l2) -> bool:
    """``hriemo/ops/fused_ffn.py::use_mlp2_int8`` without the device test:
    both Linears int8 with biases, widths that the TPU kernel tiled."""
    if l0.w_int8 is None or l2.w_int8 is None or l0.bias is None or l2.bias is None:
        return False
    f, din = l0.w_int8.shape
    dout = l2.w_int8.shape[0]
    return (din % 128 == 0 and f % 128 == 0 and dout % 128 == 0
            and (din + dout) * f <= 8 * 2 ** 20)


def use_fused_ffn(d: int, f: int) -> bool:
    """``hriemo/ops/fused_ffn.py::use_fused_ffn`` without the device test."""
    return d % 128 == 0 and f % 128 == 0 and 2 * d * f <= 8 * 2 ** 20


def ffn_reference(x, w1, b1, w2, b2, ln_w, ln_b, eps: float, fast_gelu: bool):
    """``hriemo/ops/fused_ffn.py::_xla_reference``: the unfused float block,
    ``x . W1^T`` rounded to x's dtype before ``b1`` is added; the gradient
    of :func:`ffn_block_bf16` goes through it."""
    dt = x.dtype
    h = gelu_fp32((x @ w1.to(dt).t() + b1).float(), fast_gelu).to(dt)
    y = x.float() + h @ w2.to(dt).t() + b2
    return layer_norm_rows(y, ln_w, ln_b, eps).to(dt)


def ffn_block_bf16_plain(x, w1, b1, w2, b2, ln_w, ln_b, eps: float, fast_gelu: bool):
    """Plain PyTorch version of :func:`ffn_block_bf16`, in the kernel's
    order: fp32 sums of the first product plus ``b1``, fp32 GELU rounded
    to x's dtype, fp32 sums of the second product, then ``(x + y) + b2``
    and LayerNorm in fp32."""
    dt = x.dtype
    h = gelu_fp32(x.float() @ w1.to(dt).float().t() + b1.float(), fast_gelu).to(dt)
    y = (x.float() + h.float() @ w2.to(dt).float().t()) + b2.float()
    return layer_norm_rows(y, ln_w.float(), ln_b.float(), eps).to(dt)


def _ffn_bf16_launch(x, w1, b1, w2, b2, ln_w, ln_b, eps, fast_gelu):
    m, d = x.shape
    f = w1.shape[0]
    dt, dev = x.dtype, x.device
    if dt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"ffn_block_bf16: dtype {dt}, needs bf16 or fp32")
    _cuda.require(x, "x", dt)
    _cuda.require(w1, "w1", dt, (f, d), dev)
    _cuda.require(w2, "w2", dt, (d, f), dev)
    _cuda.require(b1, "b1", torch.float32, (f,), dev)
    for t, name in ((b2, "b2"), (ln_w, "ln_w"), (ln_b, "ln_b")):
        _cuda.require(t, name, torch.float32, (d,), dev)
    if d % 32 or f % 32:
        raise ValueError(f"ffn_block_bf16: widths {d}, {f} must be multiples of 32")
    h = torch.empty((m, f), dtype=dt, device=dev)
    y = torch.empty((m, d), dtype=torch.float32, device=dev)
    if dt == torch.bfloat16:  # the TMA GEMM (csrc/tma_gemm.cuh)
        sms = _cuda.sm_count()
        plan = (*_cuda.tma_gemm_plan(1, m, f, sms), *_cuda.tma_gemm_plan(1, m, d, sms))
        _cuda.check(_cuda.lib("ffn_bf16").hr_ffn_gemms_tma(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), m, d, f,
            int(fast_gelu), h.data_ptr(), y.data_ptr(), *plan, _cuda.stream()),
            "hr_ffn_gemms_tma")
    else:  # fp32: 3xTF32 on csrc/float_wgmma.cuh
        _cuda.check(_cuda.lib("ffn_bf16").hr_ffn_gemms(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), m, d, f,
            int(fast_gelu), h.data_ptr(), y.data_ptr(), _cuda.stream()), "hr_ffn_gemms")
    out = _cuda.layernorm(y, ln_w, ln_b, eps, dt)
    ffn_block_bf16.launches += 1
    return out


class _FfnBf16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, ln_w, ln_b, eps, fast_gelu):
        ctx.save_for_backward(x, w1, b1, w2, b2, ln_w, ln_b)
        ctx.eps, ctx.fast_gelu = eps, fast_gelu
        fn = ffn_block_bf16_plain if x.device.type == "cpu" else _ffn_bf16_launch
        return fn(x, w1, b1, w2, b2, ln_w, ln_b, eps, fast_gelu)

    @staticmethod
    def backward(ctx, g):
        ins = [t.detach().requires_grad_(t.is_floating_point()) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = ffn_reference(*ins, ctx.eps, ctx.fast_gelu)
            grads = torch.autograd.grad(out, ins, g, allow_unused=True)
        return (*(gr if need else None for gr, need in zip(grads, ctx.needs_input_grad)),
                None, None)


def ffn_block_bf16(x, w1, b1, w2, b2, ln_w, ln_b, eps: float = 1e-5, fast_gelu: bool = True):
    """Fused float FFN block ``LN(x + W2 gelu(W1 x + b1) + b2)`` over ``x [M,
    D]`` bf16 or fp32, torch-layout weights ``w1 [F, D]``, ``w2 [D, F]`` of
    x's dtype, fp32 ``b1``, ``b2``, ``ln_w``, ``ln_b``; returns ``[M, D]``
    in x's dtype. On the CPU the plain version runs; on the card three
    launches (or a raise), the bf16 products on the TMA GEMM
    (``csrc/tma_gemm.cuh``), fp32's in 3xTF32 (``csrc/float_wgmma.cuh``).
    Differentiable: the backward recomputes through :func:`ffn_reference`."""
    return _FfnBf16.apply(x, w1, b1, w2, b2, ln_w, ln_b, eps, fast_gelu)


ffn_block_bf16.launches = 0


def use_ffn_bf16(d: int, f: int) -> bool:
    """Routing of float FFN blocks to :func:`ffn_block_bf16`: off, as in the
    JAX package, whose ``route_ffn_block`` sends bf16 and fp32 FFNs per op
    (``hriemo/ops/fused_ffn.py:338-342``)."""
    return False


def route_ffn_block(p_in, p_out, ln, x, eps: float, fast_gelu: bool,
                    ops: FfnOperands | None, use_kernels: bool = True):
    """Post-norm FFN block over ``x [B, L, D]`` (``route_ffn_block``,
    ``hriemo/ops/fused_ffn.py:330``): the fused kernel for int8 Linears
    whose shapes it takes (``ops`` is then set), else Linear -> GELU ->
    Linear -> LN(x + .); float Linears go to :func:`ffn_block_bf16` only
    where :func:`use_ffn_bf16` says so (never, unless a caller forces it)."""
    b, l, d = x.shape
    if ops is not None:
        fn = ffn_block_int8 if use_kernels else ffn_block_int8_plain
        return fn(x.reshape(b * l, d), ops, eps, fast_gelu).reshape(b, l, d)
    if p_in.w_int8 is None and use_ffn_bf16(d, p_in.weight.shape[0]):
        fn = ffn_block_bf16 if use_kernels else ffn_block_bf16_plain
        return fn(x.reshape(b * l, d), p_in.weight, p_in.bias.float(), p_out.weight,
                  p_out.bias.float(), ln.weight.float(), ln.bias.float(), eps,
                  fast_gelu).reshape(b, l, d)
    from ..nn.layers import gelu

    return ln(x + p_out(gelu(p_in(x), fast_gelu)), eps)
