"""PyTorch port: the WavLM attention sublayer and the MHA sublayer
(hriemo_torch/ops/attention_block.py, nn/attention.py) against the JAX
Pallas kernels in interpret mode (CPU). Sizes follow
tests/test_attention_block.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hriemo.core.masking import NEG_INF
from hriemo.nn.attention import mha_apply, mha_init
from hriemo.nn.layers import layer_norm_apply
from hriemo.ops.attention_block import attention_block_int8, mha_block_int8
from hriemo.ops.quant import quantize_tree_for_serving
from hriemo_torch.frontends.wavlm import WavLMAttention
from hriemo_torch.nn.attention import MultiheadAttention
from hriemo_torch.nn.layers import LayerNorm
from hriemo_torch.ops import _cuda
from hriemo_torch.ops import attention_block as TA
from hriemo_torch.ops.quant import quantize_for_serving

from torch_port_helpers import assert_kernel_close, bf16, flat, one_torch_thread  # noqa: F401

D, H, L, B = 256, 4, 96, 3
EPS = 1e-5


def _bf16_tree(t):
    return jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), t)


def _wavlm_layer(rng, d=D, h=H):
    lin = lambda din, dout: {
        "weight": jnp.asarray(rng.standard_normal((dout, din)) * 0.05, jnp.float32),
        "bias": jnp.asarray(rng.standard_normal(dout) * 0.02, jnp.float32)}
    ap = {"q_proj": lin(d, d), "k_proj": lin(d, d), "v_proj": lin(d, d),
          "out_proj": lin(d, d), "gru_rel_pos_const": jnp.ones((1, h, 1, 1)) * 1.3,
          "gru_rel_pos_linear": lin(d // h, 8)}
    p_ln = {"weight": jnp.ones((d,)) * 0.9, "bias": jnp.zeros((d,)) + 0.05}
    return ap, p_ln


# key lengths just past the gated panel's old limit (128) and the first
# served bucket past it (156), past the ungated panel's limit (320) and the
# first served bucket past that (343): the card holds the int8 core's three
# kernels to the plain core that these cases hold to the Pallas kernels,
# gated here (hd 64) and ungated in the MHA cases (hd 96), padded elements
# in both
CORE_BOUNDARY_KEYS = [129, 156, 321, 343]


# L=96 as tests/test_attention_block.py; L=62, the 1.25 s bucket, where the
# TPU kernel packs short elements into one tile (L <= 64)
@pytest.mark.parametrize("l", [96, 62, *CORE_BOUNDARY_KEYS])
def test_attention_block_matches_pallas_kernel(l):
    rng = np.random.default_rng(0)
    ap, p_ln = _wavlm_layer(rng)
    x = rng.standard_normal((B, l, D)).astype(np.float32) * 0.5
    pos = rng.standard_normal((H, l, l)).astype(np.float32) * 0.3
    lens = np.array([l, l - 17, l // 2])
    kpb = np.where(np.arange(l)[None, :] < lens[:, None], 0.0, NEG_INF).astype(np.float32)

    apq = quantize_tree_for_serving(_bf16_tree(ap), min_dim=64)
    ref = attention_block_int8(apq, _bf16_tree(p_ln), jnp.asarray(x, jnp.bfloat16),
                               jnp.asarray(pos, jnp.bfloat16), jnp.asarray(kpb), EPS)

    holder = torch.nn.Module()
    holder.attn, holder.ln = WavLMAttention(D, H, None), LayerNorm(D)
    holder.attn.load_state_dict({k: torch.from_numpy(v) for k, v in flat(ap).items()})
    holder.ln.load_state_dict({k: torch.from_numpy(v) for k, v in flat(p_ln).items()})
    quantize_for_serving(holder.to(torch.bfloat16), min_dim=64)
    ops = TA.wavlm_attn_operands(holder.attn, holder.ln)
    got = TA.attention_block_int8(bf16(x), ops, bf16(pos), torch.from_numpy(kpb), EPS)
    assert got.dtype == torch.bfloat16
    assert_kernel_close(got, np.asarray(ref, np.float32))
    assert TA.attention_block_int8.launches == 0

    with pytest.raises(ValueError):  # a mis-batched key bias is refused
        TA.attention_block_int8(bf16(x), ops, bf16(pos), torch.from_numpy(kpb[:1]), EPS)


@pytest.mark.parametrize("route", [None, "fused", "chain"])
def test_cpu_attention_block_takes_plain_on_either_route(route):
    """On CPU tensors the sublayer runs its plain version whatever the route
    argument (chosen or forced), and launches nothing."""
    rng = np.random.default_rng(5)
    ap, p_ln = _wavlm_layer(rng)
    holder = torch.nn.Module()
    holder.attn, holder.ln = WavLMAttention(D, H, None), LayerNorm(D)
    holder.attn.load_state_dict({k: torch.from_numpy(v) for k, v in flat(ap).items()})
    holder.ln.load_state_dict({k: torch.from_numpy(v) for k, v in flat(p_ln).items()})
    quantize_for_serving(holder.to(torch.bfloat16), min_dim=64)
    ops = TA.wavlm_attn_operands(holder.attn, holder.ln)
    x = bf16(rng.standard_normal((2, 62, D)).astype(np.float32))
    pos = bf16(rng.standard_normal((H, 62, 62)).astype(np.float32) * 0.3)
    kb = torch.zeros(2, 62)
    routes = dict(TA.attention_block_int8.routes)
    got = TA.attention_block_int8(x, ops, pos, kb, EPS, route=route)
    torch.testing.assert_close(got, TA.attention_block_int8_plain(x, ops, pos, kb, EPS),
                               atol=0, rtol=0)
    assert TA.attention_block_int8.launches == 0
    assert dict(TA.attention_block_int8.routes) == routes


@pytest.mark.parametrize("m,d,x_bytes,sms,want", [
    (384 * 62, 768, 2, 132, "fused"),    # the 1.25 s bucket at its served batch
    (64 * 249, 768, 2, 132, "fused"),    # 5 s
    (32 * 499, 768, 2, 132, "fused"),    # 10 s
    (32 * 499, 768, 4, 132, "fused"),    # the int8 tree at fp32 compute
    (4 * 499, 768, 2, 132, "fused"),     # phase 4's batch at 10 s: 0.48 waves of 2 x 384
    (4 * 124, 768, 2, 132, "chain"),     # and at 2.5 s: 0.12 waves
    (4 * 124, 768, 2, 33, "fused"),      # the same grid on a quarter of the SMs
    (1, 768, 2, 132, "chain"),           # a thin grid: one row block
    (128 * 250, 128, 2, 132, "chain"),   # no cluster spans the out-projection's 128 columns
])
def test_attention_route_choice(m, d, x_bytes, sms, want):
    """The WavLM sublayer's route by rows, width and x's dtype (plain
    Python; the card holds each route's output and time)."""
    assert TA.attention_route(m, d, x_bytes, sms) == want


@pytest.mark.parametrize("lk,gated,hd,b,want", [
    (62, True, 64, 384, "panel"), (124, True, 64, 192, "wgmma"), (128, True, 96, 64, "wgmma"),
    (129, True, 64, 128, "wgmma"), (499, True, 64, 32, "wgmma"), (1024, True, 64, 4, "sweeps"),
    (8, False, 64, 384, "panel"), (62, False, 96, 384, "panel"), (249, False, 96, 64, "wgmma"),
    (320, False, 64, 64, "panel"), (321, False, 96, 64, "wgmma"), (499, False, 96, 32, "wgmma"),
    (62, True, 32, 4, "sweeps"), (62, False, 128, 4, "sweeps"), (62, False, 192, 4, "sweeps"),
    # the gated core: the panel for one key tile, the wgmma core to 512 keys
    (64, True, 64, 384, "panel"), (65, True, 64, 256, "wgmma"), (512, True, 64, 32, "wgmma"),
    (513, True, 64, 32, "sweeps"), (187, True, 64, 1, "wgmma"), (64, True, 96, 1, "panel"),
    # ungated at the served batches: the panel to 320 keys but for four tiles
    (192, False, 96, 128, "panel"), (193, False, 96, 64, "wgmma"), (256, False, 64, 64, "wgmma"),
    (257, False, 96, 64, "panel"), (312, False, 96, 64, "panel"), (512, False, 96, 32, "wgmma"),
    (513, False, 96, 32, "sweeps"),
    # thin grids: the wgmma core below PANEL_MIN_BATCH elements, but one key tile
    (187, False, 96, 4, "wgmma"), (187, False, 96, 15, "wgmma"), (187, False, 96, 16, "panel"),
    (64, False, 96, 1, "panel"), (600, False, 96, 1, "sweeps"),
])
def test_core_panel_choice(lk, gated, hd, b, want):
    """The core's kernel by key length, gate, head dim and batch
    (``core_kernel``): the score panel for one key tile, and without the
    gate up to PANEL_MAX_KEYS_UNGATED keys from PANEL_MIN_BATCH elements
    but for four key tiles; the wgmma core to WGMMA_CAP_KEYS keys at head
    dims 64 and 96; else the two sweeps."""
    assert TA.core_kernel(lk, gated, hd, b) == want
    assert want in TA.CORE_KERNELS


@pytest.mark.parametrize("b,lq,lk,heads,x_bytes,norm,cross,sms,want", [
    (384, 62, 62, 8, 2, True, False, 132, "fused"),    # audio self at 1.25 s, its served batch
    (384, 8, 8, 12, 2, True, False, 132, "fused"),     # BERT self there
    (384, 8, 62, 8, 2, True, True, 132, "fused"),      # text -> audio
    (32, 499, 64, 8, 4, True, True, 132, "fused"),     # audio -> text at 10 s, an fp32 tree
    (4, 16, 16, 12, 2, True, False, 132, "fused"),     # phase 4's batch: the norm's launches
    (4, 16, 16, 12, 2, False, False, 132, "chain"),    # a thin grid without the norm
    (384, 8, 8, 12, 2, False, False, 132, "fused"),    # from 0.6 waves: 0.73
    (4, 499, 499, 8, 2, False, False, 132, "chain"),   # 0.48
    (8, 499, 64, 8, 2, False, True, 132, "fused"),     # cross alike: 0.95
    (4, 499, 64, 8, 2, False, True, 132, "chain"),
    (4, 64, 64, 12, 2, False, False, 1, "fused"),      # 4 row blocks on one SM
    # with the norm and the core on the wgmma warpgroups, which the chain never
    # runs (the card: fused 0.0789 / 0.0791 against the chain's 0.0917 /
    # 0.0940 ms)
    (4, 16, 499, 8, 2, True, True, 132, "fused"),
    (4, 64, 499, 8, 2, True, True, 132, "fused"),
    (2, 16, 499, 8, 2, True, True, 132, "fused"),
    (8, 16, 499, 8, 2, True, True, 132, "fused"),
    (32, 64, 499, 8, 2, True, True, 132, "fused"),     # text -> audio at 10 s
    # with the norm and the core on the two sweeps (past the wgmma core's 512
    # keys), by the estimate: the fused projections' waves of clusters (the
    # k/v grid of 2,400 or 2,000 rows spills into a partly filled wave)
    # against the chain's launches
    (4, 16, 600, 8, 2, True, True, 132, "chain"),
    (2, 16, 600, 8, 2, True, True, 132, "fused"),
    (4, 16, 1000, 8, 2, True, True, 132, "fused"),
    (2, 16, 1000, 8, 2, True, True, 132, "chain"),
    (32, 499, 499, 8, 2, True, False, 132, "fused"),   # audio self there
])
def test_mha_route_choice(b, lq, lk, heads, x_bytes, norm, cross, sms, want):
    """The MHA sublayer's route by shape, x's dtype, the caller's LayerNorm
    and the form (plain Python; the card holds each route's output and
    time)."""
    assert TA.mha_route(b, lq, lk, 768, heads, x_bytes, norm, cross, sms) == want


def test_mha_route_without_a_cluster_takes_the_chain():
    """No cluster spans d=128 (the out-projection's 128 columns)."""
    assert TA.mha_route(1000, 1000, 1000, 128, 2) == "chain"


def test_mha_route_estimate_counts_cluster_waves():
    """Without a card the estimate takes the H100's clusters at once (30 of
    4 blocks, not 132 / 4), so a k/v grid one cluster past them costs a
    second wave; with fewer SMs, one cluster for each cluster's worth."""
    assert _cuda.proj_clusters(1536, 768, 0) == 30
    assert _cuda.proj_clusters(1536, 768, 0, sms=64) == 16
    one, two = (TA._proj_ms(1536, m, 768, True, 132) for m in (1920, 1984))
    assert two > 1.8 * one
    assert TA._proj_ms(1536, 1984, 768, False, 132) < two


def _mha_pair(d, h, seed, dtype=torch.bfloat16):
    """Random packed-MHA params (non-zero biases), as the JAX int8 tree and
    as a quantized port module, in ``dtype`` (bf16 or fp32)."""
    p = mha_init(jax.random.key(seed), d)
    rng = np.random.default_rng(seed)
    p["in_proj_bias"] = jnp.asarray(rng.standard_normal(3 * d) * 0.05, jnp.float32)
    p["out_proj"]["bias"] = jnp.asarray(rng.standard_normal(d) * 0.05, jnp.float32)
    mod = MultiheadAttention(d, h)
    mod.load_state_dict({k: torch.from_numpy(v) for k, v in flat(p).items()})
    quantize_for_serving(mod.to(dtype), min_dim=128)
    jp = _bf16_tree(p) if dtype == torch.bfloat16 else p
    return quantize_tree_for_serving(jp, min_dim=128), mod


MHA_SHAPES = [
    (256, 4, 2, 96, 96, True),
    (256, 4, 2, 96, 40, False),
    (256, 4, 2, 9, 96, False),
    (384, 4, 2, 50, 50, True),      # hd=96: the q-scale fold crosses the bf16 cast
    (256, 4, 3, 20, 20, True),      # short rows the TPU kernel packs (sub=32)
    (256, 4, 5, 10, 50, False),     # packed cross, sub=64
    (256, 4, 9, 16, 16, True),      # sub=16 with element padding
    (256, 4, 3, 11, 14, False),
    (256, 8, 2, 96, 96, True),      # hd=32 and 128: the card's tile instances
    (256, 2, 2, 96, 40, False),     #   beside 64 and 96
    (384, 2, 2, 50, 50, True),      # hd=192: the wide tile instance
]


def _mha_inputs(d, b, lq, lk, self_attn, dtype=torch.bfloat16):
    """xq, xkv and a ragged key padding mask, as JAX arrays and tensors."""
    rng = np.random.default_rng(lq * lk)
    xq = rng.standard_normal((b, lq, d)).astype(np.float32) * 0.5
    xkv = xq if self_attn else rng.standard_normal((b, lk, d)).astype(np.float32) * 0.5
    lens = rng.integers(1, lk + 1, size=b)
    lens[0] = lk
    mask = np.arange(lk)[None, :] >= lens[:, None]
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jq = jnp.asarray(xq, jdt)
    jkv = jq if self_attn else jnp.asarray(xkv, jdt)
    tq = torch.from_numpy(xq).to(dtype)
    tkv = tq if self_attn else torch.from_numpy(xkv).to(dtype)
    return jq, jkv, tq, tkv, mask


@pytest.mark.parametrize("d,h,b,lq,lk,self_attn",
                         MHA_SHAPES + [(384, 4, 2, l, l, True) for l in CORE_BOUNDARY_KEYS])
def test_mha_block_matches_pallas_kernel(d, h, b, lq, lk, self_attn):
    jp, mod = _mha_pair(d, h, seed=d + lq + lk)
    jq, jkv, tq, tkv, mask = _mha_inputs(d, b, lq, lk, self_attn)
    ref = mha_block_int8(jp, jq, jkv, jnp.asarray(mask), h)
    got = TA.mha_block_int8(tq, tkv, mod.ops, torch.from_numpy(mask))
    assert got.shape == (b, lq, d) and got.dtype == torch.bfloat16
    assert_kernel_close(got, np.asarray(ref, np.float32))


def _norm_pair(d, seed, dtype):
    """The caller's LayerNorm weights rounded to ``dtype``, as JAX params
    and as the port's ``norm`` tensors."""
    rng = np.random.default_rng(seed)
    w = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    b = (0.1 * rng.standard_normal(d)).astype(np.float32)
    tw, tb = torch.from_numpy(w).to(dtype), torch.from_numpy(b).to(dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return {"weight": jnp.asarray(w, jdt), "bias": jnp.asarray(b, jdt)}, tw, tb


@pytest.mark.parametrize("eps", [1e-12, 1e-5])   # BERT's, the fusion layers'
@pytest.mark.parametrize("d,h,b,lq,lk,self_attn", MHA_SHAPES)
def test_mha_block_with_norm_matches_pallas_kernel(d, h, b, lq, lk, self_attn, eps):
    """With the caller's post-norm LayerNorm: JAX's kernel followed by the
    callers' bf16 add and ``layer_norm_apply`` (BERT, the fusion layers)."""
    jp, mod = _mha_pair(d, h, seed=d + lq + lk)
    jq, jkv, tq, tkv, mask = _mha_inputs(d, b, lq, lk, self_attn)
    jln, tw, tb = _norm_pair(d, lq + lk, torch.bfloat16)
    ref = layer_norm_apply(jln, jq + mha_block_int8(jp, jq, jkv, jnp.asarray(mask), h), eps)
    got = TA.mha_block_int8(tq, tkv, mod.ops, torch.from_numpy(mask), norm=(tw, tb, eps))
    assert got.shape == (b, lq, d) and got.dtype == torch.bfloat16
    assert_kernel_close(got, np.asarray(ref, np.float32))


@pytest.mark.parametrize("d,h,b,lq,lk,self_attn", [MHA_SHAPES[i] for i in (0, 1, 3)])
def test_mha_block_with_norm_fp32_matches_pallas_kernel(d, h, b, lq, lk, self_attn):
    """An fp32 tree (the int8 tree at fp32 compute): fp32 activations, the
    output, the residual and the LayerNorm in fp32."""
    jp, mod = _mha_pair(d, h, seed=d + lq + lk, dtype=torch.float32)
    jq, jkv, tq, tkv, mask = _mha_inputs(d, b, lq, lk, self_attn, torch.float32)
    jln, tw, tb = _norm_pair(d, lq + lk, torch.float32)
    ref = layer_norm_apply(jln, jq + mha_block_int8(jp, jq, jkv, jnp.asarray(mask), h), 1e-5)
    got = TA.mha_block_int8(tq, tkv, mod.ops, torch.from_numpy(mask), norm=(tw, tb, 1e-5))
    assert got.dtype == torch.float32
    assert_kernel_close(got, np.asarray(ref, np.float32))


@pytest.mark.parametrize("route", [None, "fused", "chain"])
@pytest.mark.parametrize("with_norm", [False, True])
def test_cpu_mha_block_takes_plain_on_either_route(route, with_norm):
    """On CPU tensors the MHA sublayer runs its plain version whatever the
    route (chosen or forced), with or without the caller's LayerNorm, and
    launches and counts nothing."""
    d, h = 256, 4
    _, mod = _mha_pair(d, h, seed=11)
    _, _, tq, tkv, mask = _mha_inputs(d, 3, 20, 33, False)
    _, tw, tb = _norm_pair(d, 5, torch.bfloat16)
    norm = (tw, tb, 1e-5) if with_norm else None
    kpm = torch.from_numpy(mask)
    routes, launches = dict(TA.mha_block_int8.routes), TA.mha_block_int8.launches
    got = TA.mha_block_int8(tq, tkv, mod.ops, kpm, norm, route=route)
    torch.testing.assert_close(got, TA.mha_block_int8_plain(tq, tkv, mod.ops, kpm, norm),
                               atol=0, rtol=0)
    assert TA.mha_block_int8.launches == launches
    assert dict(TA.mha_block_int8.routes) == routes


@pytest.mark.parametrize("lq", [4, 16])
def test_mha_module_routing_matches_jax(monkeypatch, lq):
    """nn.attention routing: 4 queries (the decoder) run per op with int8
    projections; 16 go to the MHA kernel, in both packages."""
    monkeypatch.setenv("HRIEMO_FORCE_MEGAKERNELS", "1")
    d, h, lk, b = 256, 8, 40, 2
    jp, mod = _mha_pair(d, h, seed=lq)
    rng = np.random.default_rng(lq)
    xq = rng.standard_normal((b, lq, d)).astype(np.float32)
    xkv = rng.standard_normal((b, lk, d)).astype(np.float32)
    mask = np.arange(lk)[None, :] >= np.array([[lk], [23]])
    jkv = jnp.asarray(xkv, jnp.bfloat16)
    ref, _ = mha_apply(jp, jnp.asarray(xq, jnp.bfloat16), jkv, jkv, h,
                       key_padding_mask=jnp.asarray(mask))
    tkv = bf16(xkv)
    got = mod(bf16(xq), tkv, tkv, torch.from_numpy(mask))
    assert_kernel_close(got, np.asarray(ref, np.float32))
    assert TA.use_mha_block(True, lq, lk, d, h) == (lq >= 8)


def test_wavlm_gate_rounds_weights_as_the_kernel():
    """The int8 sublayer's gate on an fp32 tree: the port's ``_gate`` on
    ``wavlm_attn_operands`` against the TPU kernel's expression, computed
    with jnp on the same params (``hriemo/ops/attention_block.py:198-200``,
    ``:464-466``): x and the gate weight rounded to bf16, fp32 sums over a
    block-diagonal [D, 8H] weight, then the two sigmoids."""
    rng = np.random.default_rng(3)
    ap, p_ln = _wavlm_layer(rng)
    g = ap["gru_rel_pos_linear"]
    g["weight"] = jnp.asarray(rng.standard_normal((8, D // H)) * 0.3, jnp.float32)
    ap["gru_rel_pos_const"] = jnp.asarray(rng.uniform(0.5, 1.5, (1, H, 1, 1)), jnp.float32)
    x = rng.standard_normal((B * L, D)).astype(np.float32)

    wg = jax.scipy.linalg.block_diag(*([g["weight"].T.astype(jnp.bfloat16)] * H))
    bg = jnp.tile(g["bias"].astype(jnp.float32), H)[None, :]
    gproj = jax.lax.dot_general(jnp.asarray(x).astype(jnp.bfloat16), wg,
                                (((1,), (0,)), ((), ())),
                                preferred_element_type=jnp.float32) + bg
    gp = gproj.reshape(B, L, H, 8)
    ga = jax.nn.sigmoid(jnp.sum(gp[..., 0:4], axis=-1))
    gb = jax.nn.sigmoid(jnp.sum(gp[..., 4:8], axis=-1))
    ref = ga * (gb * ap["gru_rel_pos_const"].reshape(H) - 1.0) + 2.0     # [B, L, H]

    holder = torch.nn.Module()
    holder.attn, holder.ln = WavLMAttention(D, H, None), LayerNorm(D)
    holder.attn.load_state_dict({k: torch.from_numpy(v) for k, v in flat(ap).items()})
    holder.ln.load_state_dict({k: torch.from_numpy(v) for k, v in flat(p_ln).items()})
    quantize_for_serving(holder, min_dim=64)       # an fp32 tree
    ops = TA.wavlm_attn_operands(holder.attn, holder.ln)
    got = TA._gate(torch.from_numpy(x), ops.wg, ops.bg, ops.gconst, B, L, H)   # [B, H, L, 1]
    np.testing.assert_allclose(got[..., 0].transpose(1, 2).numpy(), np.asarray(ref),
                               atol=1e-6, rtol=0)
