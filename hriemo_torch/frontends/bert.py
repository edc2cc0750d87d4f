"""BERT text frontend (port of ``hriemo/frontends/bert.py``, eval path).

Post-norm BERT with the HF ``BertModel`` state-dict names: embeddings
(word + position + token type) -> LN -> N x (self-attention -> add & LN ->
GELU FFN -> add & LN), and the masked-mean pooled output. An int8 layer
packs query/key/value into the MHA kernel's ``in_proj`` form
(``hriemo/frontends/bert.py:61-81``) and runs its FFN through the fused
FFN kernel (``route_ffn_block``).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..core.masking import NEG_INF, masked_mean
from ..nn.layers import LayerNorm, Linear, layer_norm
from ..ops.attention_block import (MhaOperands, mha_block_int8, mha_block_int8_plain,
                                   mha_operands, use_mha_block)
from ..ops.fused_ffn import FfnOperands, ffn_operands, route_ffn_block, use_fused_ffn
from ..utils.convert import load_flat_params, to_numpy


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    # tanh GELU: the serving setting; False is the exact erf form of HF
    fast_gelu: bool = False

    @classmethod
    def base_uncased(cls):
        return cls()

    @classmethod
    def tiny(cls, **kw):
        d = dict(vocab_size=99, hidden_size=32, num_hidden_layers=2,
                 num_attention_heads=4, intermediate_size=64,
                 max_position_embeddings=64, type_vocab_size=2)
        d.update(kw)
        return cls(**d)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        d, ff = cfg.hidden_size, cfg.intermediate_size
        self.n_heads = cfg.num_attention_heads
        self.eps = cfg.layer_norm_eps
        self.fast_gelu = cfg.fast_gelu
        self.attention = nn.ModuleDict({
            "self": nn.ModuleDict({n: Linear(d, d) for n in ("query", "key", "value")}),
            "output": nn.ModuleDict({"dense": Linear(d, d), "LayerNorm": LayerNorm(d)})})
        self.intermediate = nn.ModuleDict({"dense": Linear(d, ff)})
        self.output = nn.ModuleDict({"dense": Linear(ff, d), "LayerNorm": LayerNorm(d)})
        self.mha_ops: MhaOperands | None = None
        self.ffn_ops: FfnOperands | None = None
        self.use_kernels = True

    def prepare_kernels(self, fuse_blocks: bool = True) -> None:
        """The sublayer kernels' operands, for a block only when every
        Linear it packs is int8 (query, key, value and output; both FFN
        Linears): a block with one Linear kept in full precision runs per
        op."""
        sq, out = self.attention["self"], self.attention["output"]["dense"]
        qkv = [sq[n] for n in ("query", "key", "value")]
        self.mha_ops = None
        if fuse_blocks and all(p.w_int8 is not None for p in (*qkv, out)):
            self.mha_ops = mha_operands(torch.cat([p.w_int8 for p in qkv], 0),
                                        torch.cat([p.w_scale for p in qkv], 0),
                                        torch.cat([p.bias for p in qkv], 0),
                                        out, self.n_heads)
        p_in, p_out = self.intermediate["dense"], self.output["dense"]
        self.ffn_ops = (ffn_operands(p_in, p_out, self.output["LayerNorm"])
                        if fuse_blocks and p_in.w_int8 is not None and p_out.w_int8 is not None
                        and use_fused_ffn(p_in.w_int8.shape[1], p_in.w_int8.shape[0])
                        else None)

    def _attention(self, x, kpm):
        b, l, d = x.shape
        h = self.n_heads
        ln = self.attention["output"]["LayerNorm"]
        if self.mha_ops is not None and use_mha_block(True, l, l, d, h):
            # the residual and the LayerNorm in the kernel's out-projection
            fn = mha_block_int8 if self.use_kernels else mha_block_int8_plain
            return fn(x, x, self.mha_ops, kpm, ln.norm(self.eps))

        def proj(name):
            return self.attention["self"][name](x).reshape(b, l, h, d // h).transpose(1, 2)

        q, k, v = proj("query"), proj("key"), proj("value")
        scores = (q / math.sqrt(d // h)).float() @ k.float().transpose(-1, -2)
        if kpm is not None:
            scores = scores + torch.where(kpm, NEG_INF, 0.0)[:, None, None, :]
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        ctx = (probs.float() @ v.float()).to(x.dtype).transpose(1, 2).reshape(b, l, d)
        out = self.attention["output"]["dense"](ctx)
        return layer_norm(x + out, ln.weight, ln.bias, self.eps)

    def forward(self, x, kpm):
        x = self._attention(x, kpm)
        return route_ffn_block(self.intermediate["dense"], self.output["dense"],
                               self.output["LayerNorm"], x, self.eps, self.fast_gelu,
                               self.ffn_ops, self.use_kernels)


class BertEncoder(nn.Module):
    """Returns ``(sequence_output [B, L, d], pooled [B, d])``; pooled is the
    masked mean over tokens (the reference's utterance embedding)."""

    def __init__(self, config: BertConfig | None = None):
        super().__init__()
        cfg = self.config = config or BertConfig()
        d = cfg.hidden_size
        self.embeddings = nn.ModuleDict({
            "word_embeddings": nn.Embedding(cfg.vocab_size, d),
            "position_embeddings": nn.Embedding(cfg.max_position_embeddings, d),
            "token_type_embeddings": nn.Embedding(cfg.type_vocab_size, d),
            "LayerNorm": LayerNorm(d, cfg.layer_norm_eps)})
        self.encoder = nn.Module()
        self.encoder.layer = nn.ModuleList(BertLayer(cfg) for _ in range(cfg.num_hidden_layers))

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """The JAX package's random init (``bert.py:112-140``): N(0, 0.02)
        tables and Linears, zero biases, unit LayerNorms."""
        for m in self.modules():
            if isinstance(m, (Linear, nn.Embedding)):
                m.weight.normal_(0.0, 0.02, generator=gen)
                if isinstance(m, Linear):
                    m.bias.zero_()
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        """``input_ids [B, L]``; ``attention_mask [B, L]`` 1 = valid."""
        cfg = self.config
        l = input_ids.shape[1]
        if l > cfg.max_position_embeddings:
            raise ValueError(f"sequence length {l} exceeds max_position_embeddings "
                             f"{cfg.max_position_embeddings}")
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        e = self.embeddings
        pos_ids = torch.arange(l, device=input_ids.device)[None, :]
        x = (e["word_embeddings"].weight[input_ids]
             + e["position_embeddings"].weight[pos_ids]
             + e["token_type_embeddings"].weight[token_type_ids])
        x = e["LayerNorm"](x)
        kpm = None if attention_mask is None else attention_mask == 0
        for layer in self.encoder.layer:
            x = layer(x, kpm)
        return x, masked_mean(x, kpm)

    def from_torch_state_dict(self, sd: dict) -> "BertEncoder":
        """Load an HF ``BertModel`` state dict (port of
        ``hriemo/frontends/bert.py:186-215``): the ``bert.`` prefix is
        stripped, and ``pooler.*`` (the port pools by masked mean) and the
        ``position_ids`` buffer are skipped. The load is strict. Returns
        ``self``."""
        flat = {name.removeprefix("bert."): to_numpy(t) for name, t in sd.items()}
        return load_flat_params(self, {k: v for k, v in flat.items()
                                       if not k.startswith("pooler.")
                                       and "position_ids" not in k})
