"""WavLM audio frontend (port of ``hriemo/frontends/wavlm.py``, eval path).

Conv feature encoder (the conv-stack kernels of ``ops.conv_stack`` where
the card's readings route a bf16 waveform, else cuDNN convs with GroupNorm
statistics from the waveform's Gram matrix), feature projection,
convolutional positional embedding, and a post-norm encoder with WavLM's
gated relative position bias. Parameter names are the HF ``WavLMModel``
state-dict names the JAX package uses.

An int8 tree (``ops.quant.quantize_for_serving``) at a length the
attention kernel takes runs each layer as two kernels: the attention
sublayer (``ops.attention_block.attention_block_int8``) and the FFN block
(``ops.fused_ffn.ffn_block_int8``). Every other layer projects q/k/v per
op (int8 or float) and runs its attention core through the fused
gated-bias kernel (``ops.wavlm_attention``) at 128 <= L <= 2048, else per
op, as ``hriemo/frontends/wavlm.py:279-296`` routes. The JAX package pads
L to 128 once for its TPU tiles (``wavlm.py:352-358``); the port runs at
the true L, which gives the same valid rows. GroupNorm over the padded
waveform bucket is real semantics and stays.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from ..core.masking import NEG_INF
from ..nn.layers import LayerNorm, Linear, gelu
from ..utils.convert import load_flat_params, to_numpy
from ..ops.attention_block import (WavLMAttnOperands, attention_block_int8,
                                   attention_block_int8_plain, use_attention_block,
                                   wavlm_attn_operands)
from ..ops import conv_stack
from ..ops.fused_ffn import FfnOperands, ffn_operands, route_ffn_block, use_fused_ffn
from ..ops.wavlm_attention import use_fused, wavlm_fused_attention, wavlm_fused_attention_plain


@dataclasses.dataclass
class WavLMConfig:
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: tuple = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: tuple = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: tuple = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    num_buckets: int = 320
    max_bucket_distance: int = 800
    layer_norm_eps: float = 1e-5
    # tanh GELU: the serving setting; False is the exact erf form of HF
    fast_gelu: bool = False

    @classmethod
    def base_plus(cls):
        return cls()

    @classmethod
    def tiny(cls, **kw):
        d = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                 intermediate_size=64, conv_dim=(16, 16, 16),
                 conv_kernel=(10, 3, 2), conv_stride=(5, 2, 2),
                 num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
                 num_buckets=40, max_bucket_distance=100)
        d.update(kw)
        return cls(**d)


def feat_extract_output_lengths(cfg: WavLMConfig, input_lengths):
    """Conv stack output length (HF ``_get_feat_extract_output_lengths``)."""
    lengths = input_lengths
    for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
        lengths = (lengths - k) // s + 1
    return lengths


def relative_position_buckets(cfg: WavLMConfig, length: int, device=None):
    """T5-style bidirectional bucketing ``[L, L]`` int64 (HF ``compute_bias``).

    The large-distance branch goes through an fp32 ``log`` in the same
    order of operations as the JAX package, so the table is identical.
    """
    n = cfg.num_buckets // 2
    pos = torch.arange(length, device=device)
    rel = pos[None, :] - pos[:, None]
    buckets = (rel > 0).long() * n
    rel = rel.abs()
    max_exact = n // 2
    rel_large = max_exact + (
        torch.log(rel.float() / max_exact)
        / math.log(cfg.max_bucket_distance / max_exact)
        * (n - max_exact)).long()
    rel_large = torch.clamp_max(rel_large, n - 1)
    return buckets + torch.where(rel < max_exact, rel, rel_large)


class WavLMAttention(nn.Module):
    def __init__(self, d: int, h: int, num_buckets: int | None):
        super().__init__()
        self.n_heads = h
        self.q_proj, self.k_proj = Linear(d, d), Linear(d, d)
        self.v_proj, self.out_proj = Linear(d, d), Linear(d, d)
        self.gru_rel_pos_const = nn.Parameter(torch.ones(1, h, 1, 1))
        self.gru_rel_pos_linear = Linear(d // h, 8)
        if num_buckets is not None:  # layer 0 embeds the shared bias
            self.rel_attn_embed = nn.Embedding(num_buckets, h)
        self.use_kernels = True

    def forward(self, x, kbias, position_bias):
        """Projections per op, then the fused core or the einsum branch
        (``hriemo/frontends/wavlm.py:249-298``): the path of float trees
        and of lengths the int8 sublayer kernel skips."""
        b, l, d = x.shape
        h = self.n_heads
        hd = d // h
        proj = self.gru_rel_pos_linear(x.reshape(b, l, h, hd))
        gates = torch.sigmoid(proj.reshape(b, l, h, 2, 4).sum(-1))
        const = self.gru_rel_pos_const.reshape(1, 1, h, 1)
        gate = (gates[..., 0:1] * (gates[..., 1:2] * const - 1.0) + 2.0).transpose(1, 2)

        def heads(t):
            return t.reshape(b, l, h, hd).transpose(1, 2)

        q, k, v = heads(self.q_proj(x)), heads(self.k_proj(x)), heads(self.v_proj(x))
        if use_fused(l, hd):
            kpb = kbias if kbias is not None else torch.zeros((b, l), device=x.device)
            fn = wavlm_fused_attention if self.use_kernels else wavlm_fused_attention_plain
            ctx = fn(q, k, v, gate[..., 0], position_bias, kpb)
        else:
            scores = (q / math.sqrt(hd)).float() @ k.float().transpose(-1, -2)
            scores = scores + (gate * position_bias[None]).float()
            if kbias is not None:
                scores = scores + kbias[:, None, None, :]
            probs = torch.softmax(scores, dim=-1).to(x.dtype)
            ctx = (probs.float() @ v.float()).to(x.dtype)
        return self.out_proj(ctx.transpose(1, 2).reshape(b, l, d))


class WavLMEncoderLayer(nn.Module):
    def __init__(self, cfg: WavLMConfig, first: bool):
        super().__init__()
        d = cfg.hidden_size
        self.eps = cfg.layer_norm_eps
        self.fast_gelu = cfg.fast_gelu
        self.attention = WavLMAttention(d, cfg.num_attention_heads,
                                        cfg.num_buckets if first else None)
        self.layer_norm = LayerNorm(d, cfg.layer_norm_eps)
        self.feed_forward = nn.ModuleDict({
            "intermediate_dense": Linear(d, cfg.intermediate_size),
            "output_dense": Linear(cfg.intermediate_size, d)})
        self.final_layer_norm = LayerNorm(d, cfg.layer_norm_eps)
        self.attn_ops: WavLMAttnOperands | None = None
        self.ffn_ops: FfnOperands | None = None
        self.use_kernels = True

    def prepare_kernels(self, fuse_blocks: bool = True) -> None:
        """The sublayer kernels' operands, for a block only when every
        Linear it packs is int8 (q, k, v and out; both FFN Linears): a
        block with one Linear kept in full precision runs per op."""
        a, ff = self.attention, self.feed_forward
        projs = (a.q_proj, a.k_proj, a.v_proj, a.out_proj)
        self.attn_ops = (wavlm_attn_operands(a, self.layer_norm)
                         if fuse_blocks and all(p.w_int8 is not None for p in projs)
                         else None)
        p_in, p_out = ff["intermediate_dense"], ff["output_dense"]
        self.ffn_ops = (ffn_operands(p_in, p_out, self.final_layer_norm)
                        if fuse_blocks and p_in.w_int8 is not None and p_out.w_int8 is not None
                        and use_fused_ffn(p_in.w_int8.shape[1], p_in.w_int8.shape[0])
                        else None)

    def forward(self, x, kbias, position_bias):
        if self.attn_ops is not None and use_attention_block(True, x.shape[1], x.shape[2]):
            fn = attention_block_int8 if self.use_kernels else attention_block_int8_plain
            x = fn(x, self.attn_ops, position_bias, kbias, self.eps)
        else:
            x = self.layer_norm(x + self.attention(x, kbias, position_bias))
        ff = self.feed_forward
        return route_ffn_block(ff["intermediate_dense"], ff["output_dense"],
                               self.final_layer_norm, x, self.eps, self.fast_gelu,
                               self.ffn_ops, self.use_kernels)


class WavLMEncoder(nn.Module):
    def __init__(self, config: WavLMConfig | None = None):
        super().__init__()
        cfg = self.config = config or WavLMConfig()
        d = cfg.hidden_size
        convs = []
        for i, (cd, k, s) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride)):
            cin = 1 if i == 0 else cfg.conv_dim[i - 1]
            layer = nn.Module()
            layer.conv = nn.Conv1d(cin, cd, k, stride=s, bias=cfg.conv_bias)
            if i == 0:
                layer.layer_norm = LayerNorm(cd)  # per-channel GroupNorm params
            convs.append(layer)
        self.feature_extractor = nn.Module()
        self.feature_extractor.conv_layers = nn.ModuleList(convs)
        self.feature_projection = nn.Module()
        self.feature_projection.layer_norm = LayerNorm(cfg.conv_dim[-1], cfg.layer_norm_eps)
        self.feature_projection.projection = Linear(cfg.conv_dim[-1], d)
        self.encoder = nn.Module()
        self.encoder.pos_conv_embed = nn.Module()
        self.encoder.pos_conv_embed.conv = nn.Conv1d(
            d, d, cfg.num_conv_pos_embeddings, padding=cfg.num_conv_pos_embeddings // 2,
            groups=cfg.num_conv_pos_embedding_groups)
        self.encoder.layer_norm = LayerNorm(d, cfg.layer_norm_eps)
        self.encoder.layers = nn.ModuleList(
            WavLMEncoderLayer(cfg, i == 0) for i in range(cfg.num_hidden_layers))
        self.use_kernels = True

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """The JAX package's random init (``wavlm.py:142-201``), drawn from
        ``gen``: N(0, 0.02) Linears and tables, He-normal convs."""
        cfg = self.config
        for m in self.modules():
            if isinstance(m, Linear):
                m.weight.normal_(0.0, 0.02, generator=gen)
                m.bias.zero_()
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        for layer in self.feature_extractor.conv_layers:
            w = layer.conv.weight
            w.normal_(0.0, math.sqrt(2.0 / (w.shape[1] * w.shape[2])), generator=gen)
            if layer.conv.bias is not None:
                layer.conv.bias.zero_()
        pc = self.encoder.pos_conv_embed.conv
        pc.weight.normal_(0.0, 2 * math.sqrt(1.0 / (cfg.num_conv_pos_embeddings
                                                    * cfg.hidden_size)), generator=gen)
        pc.bias.zero_()
        for layer in self.encoder.layers:
            layer.attention.gru_rel_pos_const.fill_(1.0)
        self.encoder.layers[0].attention.rel_attn_embed.weight.normal_(0.0, 0.02, generator=gen)

    def _feature_encoder(self, input_values):
        """``input_values [B, Tw]`` -> conv features ``[B, T', C]``: the
        conv-stack kernels where ``conv_stack.use_conv_stack`` routes the
        waveform (``conv_stack.conv_stack_route``: bf16 on the card), else
        the cuDNN convs with the Gram-matrix GroupNorm statistics."""
        cfg = self.config
        if conv_stack.use_conv_stack(cfg, self.feature_extractor, input_values):
            return conv_stack.conv_stack_fused(self.feature_extractor, input_values, cfg,
                                               self.use_kernels)
        layers = range(len(cfg.conv_dim))
        return self._cudnn_convs(input_values[:, None, :], layers, input_values).transpose(
            1, 2).contiguous()  # [B, T', C]

    def _cudnn_convs(self, x, layers, wave=None, stats=None):
        """The cuDNN route's convs ``layers`` (each with its GELU; conv0 with
        its GroupNorm) over ``x [B, C_in, T]`` channel-first. conv0's
        ``(mean, var)`` come from ``stats`` if given, else from the
        waveform's Gram matrix (``wave``, the base conv0 without bias) or
        from conv0's output."""
        cfg = self.config
        convs = self.feature_extractor.conv_layers
        for i in layers:
            conv = convs[i].conv
            x = conv(x)
            if i == 0:
                gp = convs[0].layer_norm
                if stats is not None:
                    mean, var = stats
                elif (cfg.conv_kernel[0] == 10 and cfg.conv_stride[0] == 5
                        and conv.bias is None):
                    mean, var = conv_stack.group_norm_stats_from_waveform(wave, conv.weight)
                else:  # GroupNorm with one channel per group
                    xf = x.float()
                    mean = xf.mean(-1)
                    var = torch.square(xf - mean[..., None]).mean(-1)
                rstd = torch.rsqrt(var + cfg.layer_norm_eps)
                x = ((x.float() - mean[:, :, None]) * rstd[:, :, None]
                     * gp.weight.float()[None, :, None]
                     + gp.bias.float()[None, :, None]).to(x.dtype)
            x = gelu(x, cfg.fast_gelu)
        return x

    def _embed(self, feats, frame_mask=None):
        """Feature projection of the conv features ``[B, T', C]`` (pad frames
        zeroed), plus the GELU of the convolutional positional embedding,
        then the encoder's LayerNorm: the first layer's input."""
        cfg = self.config
        fp = self.feature_projection
        x = fp.projection(fp.layer_norm(feats))
        if frame_mask is not None:
            x = x * frame_mask[:, :, None].to(x.dtype)
        pos = self.encoder.pos_conv_embed.conv(x.transpose(1, 2))
        if cfg.num_conv_pos_embeddings % 2 == 0:
            pos = pos[:, :, :-1]
        x = x + gelu(pos, cfg.fast_gelu).transpose(1, 2)
        return self.encoder.layer_norm(x)

    def forward(self, input_values, attention_mask=None):
        """``input_values [B, T]`` waveform; ``attention_mask [B, T]`` 1 = valid.

        Returns ``(last_hidden_state [B, T', d], frame_mask [B, T'] int 1 = valid)``.
        """
        cfg = self.config
        feats = self._feature_encoder(input_values)
        b, t_out = feats.shape[:2]
        frame_mask = kbias = None
        if attention_mask is not None:
            out_lengths = feat_extract_output_lengths(cfg, attention_mask.sum(dim=-1))
            frame_mask = (torch.arange(t_out, device=feats.device)[None, :]
                          < out_lengths[:, None]).int()
            kbias = torch.where(frame_mask == 0, NEG_INF, 0.0).float()

        x = self._embed(feats, frame_mask)
        layers = self.encoder.layers
        buckets = relative_position_buckets(cfg, t_out, feats.device)
        position_bias = layers[0].attention.rel_attn_embed.weight[buckets]
        position_bias = position_bias.permute(2, 0, 1).contiguous()  # [H, L, L]

        if kbias is None and any(layer.attn_ops is not None for layer in layers) \
                and use_attention_block(True, t_out, cfg.hidden_size):
            kbias = torch.zeros((b, t_out), device=x.device)
        for layer in layers:
            x = layer(x, kbias, position_bias)
        return x, frame_mask

    def from_torch_state_dict(self, sd: dict) -> "WavLMEncoder":
        """Load an HF ``WavLMModel`` state dict (port of
        ``hriemo/frontends/wavlm.py:377-428``): the ``wavlm.`` prefix is
        stripped, pretraining-only tensors (``masked_spec_embed``,
        ``adapter*``) are skipped, and the positional conv's weight norm is
        folded into its plain weight, from either naming
        (``parametrizations.weight.original0/1`` or ``weight_g/weight_v``).
        The load is strict (``utils.convert.load_flat_params``). Returns
        ``self``."""
        flat, pos_g, pos_v = {}, None, None
        for name, tensor in sd.items():
            name = name.removeprefix("wavlm.")
            if name == "masked_spec_embed" or "adapter" in name:
                continue
            if "pos_conv_embed.conv." in name and name.endswith(
                    ("parametrizations.weight.original0", "weight_g")):
                pos_g = to_numpy(tensor)
            elif "pos_conv_embed.conv." in name and name.endswith(
                    ("parametrizations.weight.original1", "weight_v")):
                pos_v = to_numpy(tensor)
            else:
                flat[name] = to_numpy(tensor)
        if pos_g is not None and pos_v is not None:
            # torch weight_norm(dim=2): one norm per kernel tap, over (out, in)
            norm = np.sqrt((pos_v ** 2).sum(axis=(0, 1), keepdims=True))
            flat["encoder.pos_conv_embed.conv.weight"] = pos_g * pos_v / norm
        return load_flat_params(self, flat)
