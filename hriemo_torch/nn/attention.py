"""Multi-head attention with ``nn.MultiheadAttention`` parameters
(port of ``hriemo/nn/attention.py:39-170``).

Packed ``in_proj_weight [3d, d]`` / ``in_proj_bias [3d]`` and an
``out_proj`` Linear, ``key_padding_mask`` True = PAD as an additive NEG_INF
bias. A quantized MHA (``in_proj_w_int8``, serving only) whose shapes pass
``use_mha_block`` goes to the MHA kernel (``hriemo/nn/attention.py:85-98``).
Every other call projects per op (int8 or plain), then runs its core
through ``ops.flash_attention.flash_mha`` when ``use_flash`` holds
(Lq, Lk >= 1024) and no attention dropout is active
(``hriemo/nn/attention.py:128-148``: the fused core never holds the
probabilities), else per op: fp32 softmax, probabilities in the compute
dtype, then, in training, dropout on them (``:159-164``).

``need_weights=True`` also returns the head-averaged probabilities ``[B,
Lq, Lk]``, taken before dropout and cast to the query's dtype
(``:158-160``); such a call takes neither the MHA kernel nor ``flash_mha``,
since neither holds the probabilities (``:85``, ``:131-143``).

``norm=(weight, bias, eps)`` returns the caller's post-norm ``layer_norm(query
+ out)`` instead of ``out``: the MHA kernel takes it into its
out-projection, every other route applies it after the output projection.
A caller passes it only where nothing (no dropout) acts between the two.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..core.masking import mask_to_bias
from ..ops.attention_block import (MhaOperands, mha_block_int8, mha_block_int8_plain,
                                   mha_operands, use_mha_block)
from ..ops.flash_attention import flash_mha, flash_mha_plain, use_flash
from ..ops.quant import int8_linear, int8_linear_plain, quantize_linear_params
from .layers import Linear, dropout as _dropout, layer_norm


class MultiheadAttention(nn.Module):
    def __init__(self, d_model: int, n_heads: int, bias: bool = True, dropout: float = 0.0):
        super().__init__()
        if d_model % n_heads:
            raise ValueError("d_model must divide into n_heads")
        self.n_heads = n_heads
        self.dropout = dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model)) if bias else None
        self.out_proj = Linear(d_model, d_model, bias)
        self.register_buffer("in_proj_w_int8", None)
        self.register_buffer("in_proj_w_scale", None)
        self.ops: MhaOperands | None = None
        self.use_kernels = True

    def quantize_(self, min_dim: int) -> None:
        if self.in_proj_w_int8 is None and min(self.in_proj_weight.shape) >= min_dim:
            self.in_proj_w_int8, self.in_proj_w_scale = quantize_linear_params(
                self.in_proj_weight)
            self.in_proj_weight = None

    def prepare_kernels(self, fuse_blocks: bool = True) -> None:
        """The MHA kernel's operands when both projections are int8."""
        self.ops = (mha_operands(self.in_proj_w_int8, self.in_proj_w_scale,
                                 self.in_proj_bias, self.out_proj, self.n_heads)
                    if fuse_blocks and self.in_proj_w_int8 is not None
                    and self.out_proj.w_int8 is not None else None)

    def forward(self, query, key, value, key_padding_mask=None, generator=None,
                need_weights: bool = False, norm=None):
        """Returns the attention output ``[B, Lq, d]``, or with
        ``need_weights`` the pair ``(output, weights [B, Lq, Lk])``; with
        ``norm`` the output is ``layer_norm(query + output, *norm)``. In
        training with ``dropout > 0``, ``generator`` draws the
        probabilities' mask."""
        d = query.shape[-1]
        h = self.n_heads
        if (self.ops is not None and key is value and not need_weights
                and use_mha_block(True, query.shape[1], key.shape[1], d, h)):
            fn = mha_block_int8 if self.use_kernels else mha_block_int8_plain
            return fn(query, key, self.ops, key_padding_mask, norm)

        if self.in_proj_w_int8 is not None:
            lin = int8_linear if self.use_kernels else int8_linear_plain
            w8, ws = self.in_proj_w_int8, self.in_proj_w_scale
            q, k, v = (lin(t, w8[i * d:(i + 1) * d], ws[i * d:(i + 1) * d])
                       for i, t in enumerate((query, key, value)))
        else:
            w = self.in_proj_weight
            q, k, v = (torch.matmul(t, w[i * d:(i + 1) * d].t())
                       for i, t in enumerate((query, key, value)))
        b_in = self.in_proj_bias
        if b_in is not None:
            q, k, v = q + b_in[:d], k + b_in[d:2 * d], v + b_in[2 * d:]

        def heads(t):
            return t.reshape(t.shape[0], t.shape[1], h, d // h).transpose(1, 2)

        attn_dropout = self.training and self.dropout > 0.0
        weights = None
        if not attn_dropout and not need_weights and use_flash(heads(q).shape, heads(k).shape):
            fn = flash_mha if self.use_kernels else flash_mha_plain
            out = fn(heads(q), heads(k), heads(v), key_padding_mask)
        else:
            scale = 1.0 / math.sqrt(d // h)
            scores = heads(q * scale).float() @ heads(k).float().transpose(-1, -2)
            bias = mask_to_bias(key_padding_mask, scores.dtype)
            if bias is not None:
                scores = scores + bias
            probs = torch.softmax(scores, dim=-1)
            if need_weights:
                weights = probs.mean(dim=1).to(query.dtype)
            probs = _dropout(probs.to(query.dtype), self.dropout, generator, attn_dropout)
            out = (probs.float() @ heads(v).float()).to(query.dtype)
        out = out.transpose(1, 2).reshape(query.shape[0], query.shape[1], d)
        out = self.out_proj(out)
        if norm is not None:
            out = layer_norm(query + out, *norm)
        return (out, weights) if need_weights else out
