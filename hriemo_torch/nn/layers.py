"""Primitive layers (port of ``hriemo/nn/layers.py``).

Parameter names and layouts are the JAX package's, which are torch's
``state_dict`` names: Linear weights are ``[out, in]``, and ``MLP2`` keeps
the ``nn.Sequential`` submodule names ``0`` and ``2``. After
``ops.quant.quantize_for_serving`` a Linear holds ``w_int8``/``w_scale``
buffers in place of ``weight`` and routes to ``ops.quant.int8_linear``
(``hriemo/nn/layers.py:31-34``); an int8 ``MLP2`` routes to the mlp2 kernel
(``:89-97``).

``use_kernels`` (a plain attribute, True by default) selects, for a module
that owns a kernel call, the kernel wrapper or its plain PyTorch version;
``set_use_kernels`` sets it on a whole tree.

Dropout draws every mask from an explicit ``torch.Generator`` on x's
device (:func:`dropout`); :func:`fold_in` and :func:`derive` give each
layer, call site and step a generator of its own from one seed, as the JAX
package's ``fold_in`` gives each its key. Each row (dim 0) of a mask comes
from a generator of its own, derived from the call's seed and the row's
index in the whole batch, so a data rank draws just its rows
(:func:`dropout_rows`) and a sharded step masks as the unsharded one does,
as JAX's partitionable threefry does. A column-sharded activation draws its
rows whole and keeps its feature block (``Linear.out_block``).

A sharded Linear (``parallel/mesh.py::shard_params``) holds its block of the
weight and runs through ``Linear.tp``.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch
from torch import nn

from ..ops.fused_ffn import (Mlp2Operands, layer_norm_rows, mlp2_int8, mlp2_int8_plain,
                             mlp2_operands, use_mlp2_int8)
from ..ops.quant import int8_linear, int8_linear_plain, quantize_linear_params


def set_use_kernels(module: nn.Module, on: bool) -> nn.Module:
    """Route every kernel call under ``module`` to the kernel wrappers
    (``on``) or to their plain PyTorch versions."""
    for m in module.modules():
        if hasattr(m, "use_kernels"):
            m.use_kernels = on
    return module


@torch.no_grad()
def init_torch_defaults(module: nn.Module, gen: torch.Generator) -> None:
    """torch's default inits, which the JAX package reproduces
    (``hriemo/nn/initializers.py``): Linear weight and bias
    U(+-1/sqrt(fan_in)); MHA in_proj xavier-uniform, MHA biases 0;
    LayerNorm 1 and 0. Draws from ``gen``."""
    from .attention import MultiheadAttention

    for m in module.modules():
        if isinstance(m, Linear):
            bound = 1.0 / math.sqrt(m.weight.shape[1])
            m.weight.uniform_(-bound, bound, generator=gen)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=gen)
        elif isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    for m in module.modules():
        if isinstance(m, MultiheadAttention):
            fan_out, fan_in = m.in_proj_weight.shape
            bound = math.sqrt(6.0 / (fan_in + fan_out))
            m.in_proj_weight.uniform_(-bound, bound, generator=gen)
            for b in (m.in_proj_bias, m.out_proj.bias):
                if b is not None:
                    b.zero_()


_MASK64 = (1 << 64) - 1


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from ``seed`` and ``data`` (splitmix64 of the pair):
    the host-side counterpart of ``jax.random.fold_in``. No device work."""
    z = (seed ^ ((data + 1) * 0x9E3779B97F4A7C15)) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def derive(generator: torch.Generator | None, data: int) -> torch.Generator | None:
    """A fresh generator on ``generator``'s device, seeded from its initial
    seed and ``data``; None for None. Only the seed of ``generator`` is read,
    never its state, so the same call gives the same generator however often
    it is made (a recompute under ``torch.utils.checkpoint`` draws the same
    masks)."""
    if generator is None:
        return None
    return torch.Generator(generator.device).manual_seed(fold_in(generator.initial_seed(), data))


_ROW0 = contextvars.ContextVar("dropout_rows", default=0)


@contextlib.contextmanager
def dropout_rows(offset: int):
    """Inside, dim 0 of every tensor that :func:`dropout` masks holds rows
    ``[offset, offset + len(x))`` of the whole batch, and their masks are
    those rows of the whole batch's: a data rank's block."""
    token = _ROW0.set(offset)
    try:
        yield
    finally:
        _ROW0.reset(token)


def dropout(x, p: float, generator: torch.Generator | None, training: bool,
            features: tuple[int, int] | None = None):
    """Inverted dropout (``hriemo/nn/layers.py:54-70``): keep each element
    with probability ``1 - p`` and divide the kept ones by ``1 - p`` in x's
    dtype; the identity in eval or at ``p = 0``. A training call with
    ``p > 0`` must pass a generator on x's device: silently skipping dropout
    would leave the recipe without a warning. Only the generator's seed is
    read (as :func:`derive` does): row ``r`` of the mask (a vector is one
    row) is drawn by a generator seeded from it and ``r``'s index in the
    whole batch (:func:`dropout_rows`), so a rank's rows cost what they
    hold. ``features=(offset, total)``: x holds features ``[offset, offset +
    x.shape[-1])`` of ``total`` (a column-sharded activation), and the mask
    is that block of the whole one's."""
    if not training or p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout: training with p > 0 needs a torch.Generator; pass "
                         "generator=... to forward() (or call model.eval())")
    keep = 1.0 - p
    rows = x.reshape(1, -1) if x.ndim == 1 else x
    shape, cols = list(rows.shape), slice(None)
    if features is not None:
        shape[-1] = features[1]
        cols = slice(features[0], features[0] + x.shape[-1])
    u = torch.empty(shape, device=x.device)
    seed, row0 = generator.initial_seed(), _ROW0.get()
    for i in range(shape[0]):
        gen = torch.Generator(generator.device).manual_seed(fold_in(seed, row0 + i))
        u[i].uniform_(generator=gen)
    mask = (u[..., cols] < keep).reshape(x.shape)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def gelu(x, approximate: bool):
    """``jax.nn.gelu``. In bf16 it runs operation by operation in x's
    dtype, rounding after each step as XLA does (torch's fused GELU rounds
    once and differs from JAX in ~40% of bf16 outputs); in fp32 the fused
    form already agrees with XLA to ~1e-6."""
    if x.dtype == torch.float32:
        return torch.nn.functional.gelu(x, approximate="tanh" if approximate else "none")
    if approximate:
        c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype)
        return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * x ** 3))))
    return 0.5 * x * torch.special.erfc(-x * torch.tensor(math.sqrt(0.5), dtype=x.dtype))


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """LayerNorm with fp32 statistics whatever the compute dtype."""
    return layer_norm_rows(x.float(), weight, bias, eps).to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, d: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))
        self.fp32 = None  # fp32 copies of the weights for a kernel's epilogue

    def prepare_kernels(self, fuse_blocks: bool = True) -> None:
        """fp32 copies of the weights, taken once, for a kernel that applies
        this LayerNorm in its epilogue (``ops.attention_block.mha_block_int8``,
        which takes fp32 only). Like every operand ``quantize_for_serving``
        derives, they are taken again after the weights change."""
        self.fp32 = ((self.weight.detach().float(), self.bias.detach().float())
                     if fuse_blocks else None)

    def norm(self, eps: float | None = None):
        """``(weight, bias, eps)`` as a kernel's ``norm`` argument: the fp32
        copies once prepared, else the parameters themselves (the same
        values)."""
        w, b = self.fp32 if self.fp32 is not None else (self.weight, self.bias)
        return w, b, self.eps if eps is None else eps

    def forward(self, x, eps: float | None = None):
        return layer_norm(x, self.weight, self.bias, self.eps if eps is None else eps)


class Linear(nn.Module):
    """``x @ W^T + b``; int8 W8A8 once quantized."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None
        self.register_buffer("w_int8", None)
        self.register_buffer("w_scale", None)
        self.bias_f32 = None
        self.use_kernels = True
        self.tp = None  # a parallel.mesh.ParallelLinear once sharded

    @property
    def out_block(self) -> tuple[int, int] | None:
        """``(offset, total)`` of the output features this Linear computes
        when column-sharded (its output is that block of the whole one's),
        else None."""
        if self.tp is None or self.tp.kind != "column":
            return None
        return self.tp.offset, self.tp.total

    def quantize_(self, min_dim: int) -> None:
        if self.tp is not None:
            raise ValueError("a tensor-parallel Linear does not quantize: int8 serving "
                             "runs unsharded")
        if self.w_int8 is None and min(self.weight.shape) >= min_dim:
            self.w_int8, self.w_scale = quantize_linear_params(self.weight)
            self.weight = None

    def prepare_kernels(self, fuse_blocks: bool = True) -> None:
        if self.w_int8 is not None and self.bias is not None:
            self.bias_f32 = self.bias.detach().float()

    def forward(self, x):
        if self.w_int8 is not None:
            fn = int8_linear if self.use_kernels else int8_linear_plain
            return fn(x, self.w_int8, self.w_scale, self.bias_f32)
        if self.tp is not None:
            return self.tp(x, self.weight, self.bias)
        y = torch.matmul(x, self.weight.t())
        return y if self.bias is None else y + self.bias


class MLP2(nn.Module):
    """torch ``nn.Sequential(Linear, ReLU, Linear)``, state-dict compatible."""

    def __init__(self, d_in: int, d_hidden: int, d_out: int):
        super().__init__()
        self.add_module("0", Linear(d_in, d_hidden))
        self.add_module("2", Linear(d_hidden, d_out))
        self.ops: Mlp2Operands | None = None
        self.use_kernels = True

    def prepare_kernels(self, fuse_blocks: bool = True) -> None:
        l0, l2 = self._modules["0"], self._modules["2"]
        if l0.tp is not None or l2.tp is not None:
            raise ValueError("a tensor-parallel MLP2 has no int8 route: JAX never serves "
                             "int8 under TP")
        self.ops = mlp2_operands(l0, l2) if fuse_blocks and use_mlp2_int8(l0, l2) else None

    def forward(self, x):
        if self.ops is not None:
            return (mlp2_int8 if self.use_kernels else mlp2_int8_plain)(x, self.ops)
        return self._modules["2"](torch.relu(self._modules["0"](x)))
