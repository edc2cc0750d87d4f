"""PyTorch port: the W8A8 FFN block and mlp2 (hriemo_torch/ops/fused_ffn.py)
against the JAX Pallas kernels in interpret mode (CPU)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hriemo.ops import fused_ffn as JF
from hriemo.ops.quant import quantize_linear_params
from hriemo_torch.nn.layers import MLP2
from hriemo_torch.ops import _cuda as TC
from hriemo_torch.ops import fused_ffn as TF
from hriemo_torch.ops.quant import quantize_for_serving

from torch_port_helpers import assert_kernel_close, bf16, one_torch_thread  # noqa: F401


def _linear(rng, din, dout):
    return {"weight": jnp.asarray((rng.standard_normal((dout, din)) * 0.05).astype(np.float32)),
            "bias": jnp.asarray((rng.standard_normal(dout) * 0.02).astype(np.float32))}


def _port_pair(p0, p2):
    """The JAX Linear pair as a quantized port MLP2 (bf16, as served)."""
    f, din = p0["weight"].shape
    m = MLP2(din, f, p2["weight"].shape[0])
    m.load_state_dict({f"{i}.{k}": torch.from_numpy(np.array(p[k]))
                       for i, p in (("0", p0), ("2", p2)) for k in ("weight", "bias")})
    return quantize_for_serving(m.to(torch.bfloat16), min_dim=64)


def _jax_bf16(p):
    return {k: v.astype(jnp.bfloat16) for k, v in p.items()}


@pytest.mark.parametrize("fast_gelu", [True, False])
def test_ffn_block_matches_pallas_kernel(fast_gelu):
    rng = np.random.default_rng(0)
    d, f, m = 256, 512, 300  # 300 rows: not a multiple of the TPU block
    p_in, p_out = _linear(rng, d, f), _linear(rng, f, d)
    ln_w = rng.standard_normal(d).astype(np.float32) * 0.2 + 1
    ln_b = rng.standard_normal(d).astype(np.float32) * 0.1
    x = rng.standard_normal((m, d)).astype(np.float32)

    q_in = quantize_linear_params(_jax_bf16(p_in))
    q_out = quantize_linear_params(_jax_bf16(p_out))
    qp = dict(w1_q=q_in["w_int8"].T, w1_s=q_in["w_scale"].T,
              b1=q_in["bias"].astype(jnp.float32)[None, :],
              w2_q=q_out["w_int8"].T, w2_s=q_out["w_scale"].T,
              b2=q_out["bias"].astype(jnp.float32)[None, :])
    ref = JF.ffn_block_int8(jnp.asarray(x, jnp.bfloat16), qp, jnp.asarray(ln_w),
                            jnp.asarray(ln_b), 1e-5, fast_gelu)

    pair = _port_pair(p_in, p_out)
    ops = TF.FfnOperands(pair.ops, torch.from_numpy(ln_w), torch.from_numpy(ln_b))
    got = TF.ffn_block_int8(bf16(x), ops, 1e-5, fast_gelu)
    assert got.dtype == torch.bfloat16
    assert_kernel_close(got, np.asarray(ref, np.float32))
    assert TF.ffn_block_int8.launches == 0  # CPU tensors take the plain version


@pytest.mark.parametrize("din,f,dout", [(256, 1024, 256),   # fusion FFN shape class
                                        (1024, 128, 256)])  # beta gate: rectangular
def test_mlp2_matches_pallas_kernel(din, f, dout):
    rng = np.random.default_rng(din + f)
    p0, p2 = _linear(rng, din, f), _linear(rng, f, dout)
    x = rng.standard_normal((3, 37, din)).astype(np.float32)
    ref = JF.mlp2_int8(quantize_linear_params(_jax_bf16(p0)),
                       quantize_linear_params(_jax_bf16(p2)), jnp.asarray(x, jnp.bfloat16))
    pair = _port_pair(p0, p2)
    assert pair.ops is not None  # routed to the kernel
    got = pair(bf16(x))
    assert got.shape == (3, 37, dout)
    assert_kernel_close(got, np.asarray(ref, np.float32))


@pytest.mark.parametrize("n,ln,want", [
    (768, True, 128),     # WavLM / BERT FFN: the LayerNorm over 6 x 128
    (256, True, 128),     # d=256: over 2 x 128
    (1024, True, 128),    # 8 x 128, the largest LayerNorm cluster
    (1152, True, None),   # 9 blocks: past the LayerNorm's cluster of 8
    (768, False, 192),    # mlp2: no LayerNorm, no cluster, the wider block
    (256, False, 128),    # the beta gate at d=256
])
def test_ffn_tma_second_product_width(n, ln, want):
    """The second product's block width by outputs: 128 columns with the
    LayerNorm at any rows (a 192-column block spilled the values of y it
    holds, and was slower), the widest block that divides the outputs
    without it."""
    assert TC.ffn_tma_block2(n, 3072, ln) == want


# the TMA route's tails (csrc/ffn_tma.cu): one row, rows off its 64-row
# (first product) and 128-row (second) tiles, fp32 x, the erf GELU, the
# beta gate's widths; the plain version on the CPU against the Pallas
# kernels in interpret mode, at the kernel tolerance of torch_port_helpers
TAILS = [
    ("ffn", 1, 256, 512, 256, "bfloat16", True),
    ("ffn", 65, 256, 512, 256, "float32", False),
    ("ffn", 129, 256, 1024, 256, "bfloat16", False),
    ("ffn", 193, 256, 512, 256, "float32", True),
    ("mlp2", 1, 256, 1024, 256, "bfloat16", None),
    ("mlp2", 65, 256, 1024, 256, "float32", None),
    ("mlp2", 65, 3072, 256, 768, "bfloat16", None),
]


@pytest.mark.parametrize("kind,m,din,f,dout,dtype,fast_gelu", TAILS)
def test_pair_tails_match_pallas_kernel(kind, m, din, f, dout, dtype, fast_gelu):
    rng = np.random.default_rng(m + din + f)
    p0, p2 = _linear(rng, din, f), _linear(rng, f, dout)
    x = rng.standard_normal((m, din)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    pair = _port_pair(p0, p2)
    if kind == "mlp2":
        ref = JF.mlp2_int8(quantize_linear_params(_jax_bf16(p0)),
                           quantize_linear_params(_jax_bf16(p2)), jx)
        got = TF.mlp2_int8(tx, pair.ops)
    else:
        ln_w = rng.standard_normal(dout).astype(np.float32) * 0.2 + 1
        ln_b = rng.standard_normal(dout).astype(np.float32) * 0.1
        q_in = quantize_linear_params(_jax_bf16(p0))
        q_out = quantize_linear_params(_jax_bf16(p2))
        qp = dict(w1_q=q_in["w_int8"].T, w1_s=q_in["w_scale"].T,
                  b1=q_in["bias"].astype(jnp.float32)[None, :],
                  w2_q=q_out["w_int8"].T, w2_s=q_out["w_scale"].T,
                  b2=q_out["bias"].astype(jnp.float32)[None, :])
        ref = JF.ffn_block_int8(jx, qp, jnp.asarray(ln_w), jnp.asarray(ln_b), 1e-5, fast_gelu)
        ops = TF.FfnOperands(pair.ops, torch.from_numpy(ln_w), torch.from_numpy(ln_b))
        got = TF.ffn_block_int8(tx, ops, 1e-5, fast_gelu, route="tma")
    assert got.dtype == tx.dtype and got.shape == (m, dout)
    assert_kernel_close(got, np.asarray(ref, np.float32))


def test_mlp2_routing_predicate():
    """use_mlp2_int8 without the device test: unquantized or untileable
    pairs run per op, exactly as in JAX."""
    rng = np.random.default_rng(5)
    p0, p2 = _linear(rng, 256, 256), _linear(rng, 256, 192)  # 192 % 128 != 0
    pair = _port_pair(p0, p2)
    assert pair.ops is None
    x = rng.standard_normal((4, 256)).astype(np.float32)
    from hriemo.nn.layers import mlp2_apply
    ref = mlp2_apply({"0": quantize_linear_params(_jax_bf16(p0)),
                      "2": quantize_linear_params(_jax_bf16(p2))}, jnp.asarray(x, jnp.bfloat16))
    assert_kernel_close(pair(bf16(x)), np.asarray(ref, np.float32))


GELU, ERF, RELU = TC.EPI_GELU_F32, TC.EPI_GELU_ERF_F32, TC.EPI_RELU_F32


@pytest.mark.parametrize("f,m,k,epi,sms,want", [
    (3072, 1996, 768, GELU, 132, "tma"),      # WavLM FFN, 10 s bucket at B=4 (PERF.md row 3)
    (3072, 3072, 768, GELU, 132, "tma"),      # BERT's FFN at 384 x 8 tokens
    (3072, 4096, 768, GELU, 132, "tma"),
    (3072, 6144, 768, GELU, 132, "tma"),
    (3072, 4096, 768, GELU, 66, "tma"),       # the same grid on half the SMs
    (3072, 23808, 768, GELU, 132, "tma"),     # WavLM FFN at 384 x 62 frames
    (3072, 15968, 768, ERF, 132, "tma"),
    (3072, 1024, 768, RELU, 132, "tma"),
    (3072, 1996, 768, RELU, 132, "tma"),      # fusion FFN, 10 s bucket at B=4 (row 4)
    (3072, 3072, 768, RELU, 132, "tma"),      # fusion FFN over 384 x 8 text rows
    (1024, 1024, 256, RELU, 132, "tma"),      # fusion FFN at d=256: 1.07 waves of 15
    (1024, 3072, 256, GELU, 132, "tma"),
    (256, 4, 3072, RELU, 132, "chain"),       # the beta gate at d=768: W1's slice does not fit
    (256, 384, 3072, RELU, 132, "chain"),
    (256, 384, 1024, RELU, 132, "chain"),     # the beta gate at d=256: a thin grid
    (1408, 23808, 128, GELU, 132, "chain"),   # no power-of-two cluster spans 1408 columns
    (3072, 1024, 768, GELU, 132, "tma"),      # 2.3 waves of the TMA route's 7 clusters
    (3072, 256, 768, GELU, 132, "chain"),     # 0.6 waves
    (256, 4096, 1024, RELU, 132, "tma"),      # the beta gate at d=256 over 0.97 waves
    (256, 1024, 1024, RELU, 132, "chain"),
    (3072, 499, 768, GELU, 132, "chain"),     # WavLM FFN at B=1 over 10 s
    (1024, 3072, 256, RELU, 132, "tma"),      # fusion FFN at d=256: 3.2 waves of 15
    (1024, 8192, 256, RELU, 132, "tma"),
])
def test_ffn_route_choice(f, m, k, epi, sms, want):
    """The pair's route by rows, widths, activation and the card's SMs
    (plain Python; the card holds each route's output and time)."""
    assert TC.ffn_route(f, m, k, epi, sms) == want


# the bench's served calls of the pair (chip_smoke.py SERVED_FFN_ROWS,
# SERVED_MLP2_ROWS, MEASURED_BUCKET_BATCH): WavLM's FFN over B x L frames of
# every bucket (13,952-23,936 rows; B=1 at 3.75 s: 187), BERT's over B x
# its text bucket (2,048-3,072), the fusion FFN over the audio and text rows
# and phase 4's 4 x 64, the beta gate over the batch
SERVED_PICKS = [
    ("wavlm", 3072, 768, 768, GELU, (384 * 62, 256 * 93, 192 * 124, 128 * 155, 128 * 187,
                                     64 * 218, 64 * 249, 32 * 499, 23936, 13952), "tma"),
    ("wavlm B=1", 3072, 768, 768, GELU, (187,), "chain"),
    ("bert", 3072, 768, 768, GELU, (2048, 3072), "tma"),
    ("fusion", 3072, 768, 768, RELU, (384 * 62, 384 * 8, 32 * 499), "tma"),
    ("fusion, phase 4's text rows", 3072, 768, 768, RELU, (4 * 64,), "chain"),
    ("beta gate", 256, 3072, 768, RELU, (32, 64, 128, 192, 256, 384), "chain"),
]


@pytest.mark.parametrize("what,f,k,n,epi,rows,want", SERVED_PICKS,
                         ids=[c[0] for c in SERVED_PICKS])
def test_ffn_route_served_picks(what, f, k, n, epi, rows, want):
    """The route at every served call of the pair on an H100's 132 SMs."""
    for m in rows:
        assert TC.ffn_route(f, m, k, epi, TC.H100_SMS, n=n) == want, (what, m)


@pytest.mark.parametrize("f,k,n,ln,want", [
    (3072, 768, 768, True, (192, 128)),    # WavLM / BERT FFN: 16 x 192, LayerNorm over 6 x 128
    (3072, 768, 768, False, (192, 192)),   # fusion FFN
    (1024, 256, 256, True, (128, 128)),    # d=256: 8 x 128, LayerNorm over 2 x 128
    (2048, 512, 512, True, (128, 128)),
    (256, 1024, 256, False, (128, 128)),   # the beta gate at d=256: 2 x 128
    (256, 3072, 768, False, None),         # the beta gate at d=768: W1's slice does not fit
    (3072, 1024, 768, True, None),         # 192 x 1024 bytes of W1 do not fit
    (1408, 128, 128, True, None),          # 11 blocks of 128: no power of two
    (6144, 768, 768, True, None),          # 32 blocks: past the largest cluster
    (3072, 768, 1152, True, None),         # 9 blocks of 128: past the LayerNorm's cluster
    (3072, 768, 1920, True, None),         # 10 blocks: past the LayerNorm's cluster of 8
])
def test_ffn_tma_plan(f, k, n, ln, want):
    """The TMA route's block widths (plain Python; the card's shared memory
    is csrc/ffn_tma.cu's layout, mirrored by ``ffn_tma_smem1``)."""
    assert TC.ffn_tma_plan(f, k, n, ln) == want
    if want is not None:
        assert TC.ffn_tma_smem1(want[0], k, 2, f // want[0]) <= TC.FFN_TMA_SMEM


def test_ffn_tma_spans_every_model_width():
    """Every pair of widths a model of the repo reaches takes the TMA route
    (WavLM/BERT/fusion at d=768, fusion at d=256, the beta gate at d=256),
    each block's W1 slice beside a ring of two x tiles in shared memory, but
    the beta gate's 256 columns over 3072 inputs, whose W1 slice does not
    fit: it takes the chain at any rows."""
    for f, k, n, ln in ((3072, 768, 768, True), (3072, 768, 768, False),
                        (1024, 256, 256, True), (1024, 256, 256, False),
                        (256, 1024, 256, False)):
        bn1, bn2 = TC.ffn_tma_plan(f, k, n, ln)
        assert f % bn1 == 0 and f // bn1 <= 16 and n % bn2 == 0
        assert TC.ffn_tma_smem1(bn1, k, 2, f // bn1) <= TC.FFN_TMA_SMEM
    assert TC.ffn_tma_plan(256, 3072, 768, False) is None
    for m in (1, 384, 23808):
        assert TC.ffn_route(256, m, 3072, TC.EPI_RELU_F32, n=768) == "chain"


# the first rows at which the TMA route is taken (TMA_MIN_WAVES: 2 waves of
# the first product's 64-row tiles over the clusters an H100 runs at once
# for the GELU forms, 0.75 for ReLU), one row short of each and on it: at
# 768 -> 3072 (7 clusters of 16), 256 -> 1024 (15 of 8) and the beta gate at
# d=256 (66 of 2)
THRESHOLDS = [
    (3072, 768, 768, GELU, 833), (3072, 768, 768, ERF, 833), (3072, 768, 768, RELU, 321),
    (1024, 256, 256, GELU, 1857), (1024, 256, 256, RELU, 705), (256, 1024, 256, RELU, 3137),
]


@pytest.mark.parametrize("f,k,n,epi,first", THRESHOLDS,
                         ids=[f"{c[1]}-{c[0]}-{c[2]}-epi{c[3]}" for c in THRESHOLDS])
@pytest.mark.parametrize("short", [True, False])
def test_ffn_route_threshold(f, k, n, epi, first, short):
    """The route one row below the first row the TMA route takes is the
    chain, and on it the TMA route."""
    m = first - 1 if short else first
    assert TC.ffn_route(f, m, k, epi, TC.H100_SMS, n=n) == ("chain" if short else "tma")


@pytest.mark.parametrize("chain", [False, True])
def test_cpu_wrappers_take_plain_on_either_route(chain):
    """On CPU tensors both wrappers run their plain versions whatever the
    route argument (forced or chosen), and launch nothing."""
    rng = np.random.default_rng(11)
    p0, p2 = _linear(rng, 256, 512), _linear(rng, 512, 256)
    pair = _port_pair(p0, p2)
    ln_w = torch.from_numpy(rng.standard_normal(256).astype(np.float32))
    ln_b = torch.from_numpy(rng.standard_normal(256).astype(np.float32))
    ops = TF.FfnOperands(pair.ops, ln_w, ln_b)
    x = bf16(rng.standard_normal((9, 256)).astype(np.float32))
    counters = (TF.ffn_block_int8, TF.mlp2_int8, TC.ffn_tma_xquant, TC.ffn_tma_gemm1,
                TC.ffn_tma_gemm2, TC.rowquant, TC.int8_gemm, TC.layernorm)
    launches = tuple(c.launches for c in counters)
    for route in ("chain",) if chain else (None, "tma"):
        torch.testing.assert_close(TF.ffn_block_int8(x, ops, 1e-5, True, route=route),
                                   TF.ffn_block_int8_plain(x, ops, 1e-5, True), atol=0, rtol=0)
        torch.testing.assert_close(TF.mlp2_int8(x, pair.ops, route=route),
                                   TF.mlp2_int8_plain(x, pair.ops), atol=0, rtol=0)
    assert tuple(c.launches for c in counters) == launches
