"""Analytic count of the products one served forward computes.

The JAX bench took its FLOPs from XLA's cost analysis of the compiled
forward (``tools/bucket_flops.py:34-60``); PyTorch has no counterpart that
sees the port's ctypes kernels. So the count is made from the shapes: the
multiply-adds of every product the model computes at the padded shapes
(2 operations each), from the formulas of ``tools/perf_budget.py:73-92``
(``conv_stack_flops``, ``mha_flops``) completed from the port's modules:

* WavLM: the conv stack, the feature projection, the positional conv, and
  per layer the q/k/v/out projections, the gate's per-head ``hd -> 8``
  product, q.k^T and p.v, and the FFN;
* BERT at the text bucket: projections, q.k^T and p.v, FFN;
* the fusion stack (four attentions and two FFNs a layer), the beta MLP,
  and the decoder (self- and cross-attention of the E emotion queries, its
  FFN and output projection).

Left out on purpose: the GroupNorm statistics from the waveform's Gram
matrices (``ops/conv_stack.group_norm_stats_from_waveform``; the fused
stack's stats kernel computes them otherwise), and every elementwise op,
LayerNorm, softmax, (de)quantization and gather. So the counts are not
comparable with ``bucket_flops.json``, whose XLA counts include those.

Each product is filed under the dtype it runs in on the card, by the
port's routing: int8 for a W8A8 Linear (both dims >= ``min_dim``), bf16
for the attention cores of the int8 sublayer kernels, the compute dtype for
float Linears, the convolutions and the fused float attention kernels, and
fp32 for the per-op attention cores (scores and p.v in fp32).
"""

from __future__ import annotations

import dataclasses

from ..ops.attention_block import use_attention_block, use_mha_block
from ..ops.flash_attention import use_flash
from ..ops.quant import DEFAULT_MIN_DIM
from ..ops.wavlm_attention import use_fused

# NVIDIA H100 SXM data sheet, dense: int8 tensor-core op/s, bf16 tensor-core
# op/s, fp32 op/s outside the tensor cores
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "fp32": 67e12}
DTYPES = tuple(PEAK_OPS)


@dataclasses.dataclass
class Products:
    """Named products of one forward: ``{name: (operations, dtype)}``,
    operations summed over every call of that name."""
    items: dict = dataclasses.field(default_factory=dict)

    def add(self, name: str, ops: float, dtype: str) -> None:
        if dtype not in PEAK_OPS:
            raise ValueError(f"{name}: dtype {dtype!r} is none of {DTYPES}")
        prev, prev_dt = self.items.get(name, (0.0, dtype))
        if prev_dt != dtype:
            raise ValueError(f"{name}: filed under {prev_dt} and {dtype}")
        self.items[name] = (prev + ops, dtype)

    def by_dtype(self) -> dict:
        out = dict.fromkeys(DTYPES, 0.0)
        for ops, dt in self.items.values():
            out[dt] += ops
        return out

    @property
    def total(self) -> float:
        return sum(ops for ops, _ in self.items.values())

    def bound_s(self) -> float:
        """The least time the card's compute could take: each dtype's
        operations at its peak rate."""
        return sum(ops / PEAK_OPS[dt] for dt, ops in self.by_dtype().items())


def mm(rows: int, k: int, n: int) -> float:
    """Operations of ``[rows, k] . [k, n]``."""
    return 2.0 * rows * k * n


def conv_lengths(kernels, strides, samples: int) -> list[int]:
    out, t = [], samples
    for k, s in zip(kernels, strides):
        t = (t - k) // s + 1
        out.append(t)
    return out


class _Route:
    """The dtype of each product under the port's routing."""

    def __init__(self, int8: bool, compute: str, min_dim: int):
        if compute not in ("bf16", "fp32"):
            raise ValueError(f"compute must be 'bf16' or 'fp32', got {compute!r}")
        self.int8, self.compute, self.min_dim = int8, compute, min_dim

    def linear(self, d_in: int, d_out: int) -> str:
        return "int8" if self.int8 and min(d_in, d_out) >= self.min_dim else self.compute

    def mha_core(self, lq: int, lk: int, d: int, h: int) -> str:
        """An MHA's q.k^T and p.v: the int8 MHA kernel's bf16 core, the flash
        kernels in the compute dtype, or per op in fp32."""
        if self.int8 and d >= self.min_dim and use_mha_block(True, lq, lk, d, h):
            return "bf16"
        if use_flash((1, h, lq, d // h), (1, h, lk, d // h)):
            return self.compute
        return "fp32"


def _mha(p: Products, r: _Route, name: str, b, lq, lk, d, h):
    p.add(f"{name}.proj", mm(b * (2 * lq + 2 * lk), d, d), r.linear(d, 3 * d))
    p.add(f"{name}.core", 2 * mm(b * lq, d, lk), r.mha_core(lq, lk, d, h))


def served_products(wavlm_cfg, bert_cfg, fusion: dict, batch: int, samples: int, lt: int,
                    int8: bool = True, compute: str = "bf16",
                    min_dim: int = DEFAULT_MIN_DIM) -> Products:
    """The products of one ``StreamingPipeline`` forward: ``batch`` clips
    padded to ``samples`` waveform samples, text padded to ``lt`` tokens.
    ``fusion``: ``FusionWithEmotionDecoder``'s arguments (``d_model``,
    ``num_emotions``, ``n_heads``, ``num_layers_fusion``,
    ``num_layers_decoder``, ``beta_hidden``). ``int8``: the W8A8 tree;
    ``compute``: its activation dtype, ``"bf16"`` or ``"fp32"``."""
    r = _Route(int8, compute, min_dim)
    p = Products()
    b = batch

    # WavLM: conv stack, feature projection, positional conv
    w = wavlm_cfg
    lens = conv_lengths(w.conv_kernel, w.conv_stride, samples)
    cin = 1
    for i, (cout, k, t) in enumerate(zip(w.conv_dim, w.conv_kernel, lens)):
        p.add(f"wavlm.conv{i}", mm(b * t, cin * k, cout), compute)
        cin = cout
    la, d, h = lens[-1], w.hidden_size, w.num_attention_heads
    p.add("wavlm.feature_projection", mm(b * la, cin, d), r.linear(cin, d))
    kpos, groups = w.num_conv_pos_embeddings, w.num_conv_pos_embedding_groups
    t_pos = la + 2 * (kpos // 2) - kpos + 1  # before the even kernel's last frame is cut
    p.add("wavlm.pos_conv", mm(b * t_pos, d // groups * kpos, d), compute)
    # the layers: the int8 sublayer kernel, else q/k/v/out per op and the
    # fused float core (128..2048 frames) or the per-op fp32 core
    nl, f = w.num_hidden_layers, w.intermediate_size
    block = int8 and d >= min_dim and use_attention_block(True, la, d)
    p.add("wavlm.attn.proj", nl * 4 * mm(b * la, d, d), r.linear(d, d))
    p.add("wavlm.attn.gate", nl * mm(b * la * h, d // h, 8), "fp32" if block else compute)
    core = "bf16" if block else compute if use_fused(la, d // h) else "fp32"
    p.add("wavlm.attn.core", nl * 2 * mm(b * la, d, la), core)
    p.add("wavlm.ffn", nl * (mm(b * la, d, f) + mm(b * la, f, d)), r.linear(d, f))

    # BERT at the text bucket
    bc = bert_cfg
    db, hb, fb = bc.hidden_size, bc.num_attention_heads, bc.intermediate_size
    for _ in range(bc.num_hidden_layers):
        _mha(p, r, "bert.attn", b, lt, lt, db, hb)
        p.add("bert.ffn", mm(b * lt, db, fb) + mm(b * lt, fb, db), r.linear(db, fb))

    # the fusion stack: per layer self-attention of each modality, then
    # audio-queries-text and text-queries-audio, and an FFN(4d) per modality
    df, hf = fusion["d_model"], fusion["n_heads"]
    for _ in range(fusion["num_layers_fusion"]):
        for name, lq, lk in (("fusion.self_a", la, la), ("fusion.self_t", lt, lt),
                             ("fusion.a2t", la, lt), ("fusion.t2a", lt, la)):
            _mha(p, r, name, b, lq, lk, df, hf)
        for name, rows in (("fusion.ffn_a", la), ("fusion.ffn_t", lt)):
            p.add(name, mm(b * rows, df, 4 * df) + mm(b * rows, 4 * df, df),
                  r.linear(df, 4 * df))
    # beta gate MLP(4d -> hidden -> d), one row per clip
    hid = fusion["beta_hidden"]
    p.add("beta.mlp0", mm(b, 4 * df, hid), r.linear(4 * df, hid))
    p.add("beta.mlp2", mm(b, hid, df), r.linear(hid, df))
    # the decoder: E queries over the fused memory (the text's length
    # unless both modalities have one length)
    e, lm, ff = fusion["num_emotions"], lt if la != lt else la, 2048
    for _ in range(fusion["num_layers_decoder"]):
        _mha(p, r, "decoder.self", b, e, e, df, hf)
        _mha(p, r, "decoder.cross", b, e, lm, df, hf)
        p.add("decoder.ffn", mm(b * e, df, ff) + mm(b * e, ff, df), r.linear(df, ff))
    p.add("decoder.out_proj", mm(b * e, df, 1), r.linear(df, 1))
    return p
