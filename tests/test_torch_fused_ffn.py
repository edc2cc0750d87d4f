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


@pytest.mark.parametrize("f,k,config,want", [
    (3072, 768, -1, (0, 8)),     # WavLM / BERT / fusion FFN: 8 blocks of 384
    (3072, 768, 1, (1, 12)),     # 12 x 256 forced (non-portable)
    (1024, 256, -1, (1, 4)),     # fusion FFN at d=256
    (256, 1024, -1, (1, 1)),     # beta gate at d=256: one block of 256
    (768, 768, -1, (0, 2)),
    (3072, 1536, -1, (1, 12)),   # K past the 384-column block's shared memory
    (256, 3072, -1, None),       # beta gate at d=768: 64 rows of K=3072 fit no block
    (1408, 128, -1, None),       # no cluster spans 1408 columns
    (1024, 256, 0, None),        # 1024 is no multiple of 384
    (8192, 256, -1, None),       # 32 blocks of 256: past the largest cluster
])
def test_ffn_cluster_choice(f, k, config, want):
    """The fused first GEMM's block and cluster by hidden and input width
    (plain Python; the card holds the kernels)."""
    assert TC.ffn_cluster(f, k, config) == want


GELU, ERF, RELU = TC.EPI_GELU_F32, TC.EPI_GELU_ERF_F32, TC.EPI_RELU_F32


@pytest.mark.parametrize("f,m,k,epi,sms,want", [
    (3072, 1996, 768, GELU, 132, "chain"),    # WavLM FFN, 10 s bucket at B=4 (PERF.md row 3)
    (3072, 3072, 768, GELU, 132, "chain"),    # BERT's FFN at 384 x 8 tokens
    (3072, 4096, 768, GELU, 132, "chain"),
    (3072, 6144, 768, GELU, 132, "fused"),
    (3072, 4096, 768, GELU, 66, "fused"),     # the same grid on half the SMs
    (3072, 23808, 768, GELU, 132, "fused"),   # WavLM FFN at 384 x 62 frames
    (3072, 15968, 768, ERF, 132, "fused"),
    (3072, 1024, 768, RELU, 132, "chain"),
    (3072, 1996, 768, RELU, 132, "fused"),    # fusion FFN, 10 s bucket at B=4 (row 4)
    (3072, 3072, 768, RELU, 132, "fused"),    # fusion FFN over 384 x 8 text rows
    (1024, 1024, 256, RELU, 132, "chain"),    # fusion FFN at d=256
    (1024, 3072, 256, GELU, 132, "fused"),
    (256, 4, 3072, RELU, 132, "chain"),       # the beta gate at d=768: no cluster
    (256, 384, 3072, RELU, 132, "chain"),
    (256, 384, 1024, RELU, 132, "chain"),     # the beta gate at d=256: a thin grid
    (1408, 23808, 128, GELU, 132, "chain"),   # no cluster spans 1408 columns
])
def test_ffn_route_choice(f, m, k, epi, sms, want):
    """The pair's route by rows, widths, activation and the card's SMs
    (plain Python; the card holds each route's output and time)."""
    assert TC.ffn_route(f, m, k, epi, sms) == want


def test_ffn_cluster_spans_every_model_width():
    """Every hidden width a model of the repo reaches is spanned at its
    input width (WavLM/BERT/fusion at d=768, fusion at d=256, the beta gate
    at d=256) but the beta gate's 256 columns over 3072 inputs, whose 64
    rows no block's shared memory holds: it takes the chain at any rows."""
    for f, k in ((3072, 768), (1024, 256), (256, 1024)):
        cfg, blocks = TC.ffn_cluster(f, k)
        bn, most, kmax = TC.FFN_CONFIGS[cfg]
        assert bn * blocks == f and blocks <= most and k <= kmax
    assert TC.ffn_cluster(256, 3072) is None
    for m in (1, 384, 23808):
        assert TC.ffn_route(256, m, 3072, TC.EPI_RELU_F32) == "chain"


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
    launches = (TF.ffn_block_int8.launches, TF.mlp2_int8.launches, TC.ffn_gemm1.launches)
    for route in ("chain",) if chain else (None, "fused"):
        torch.testing.assert_close(TF.ffn_block_int8(x, ops, 1e-5, True, route=route),
                                   TF.ffn_block_int8_plain(x, ops, 1e-5, True), atol=0, rtol=0)
        torch.testing.assert_close(TF.mlp2_int8(x, pair.ops, route=route),
                                   TF.mlp2_int8_plain(x, pair.ops), atol=0, rtol=0)
    assert (TF.ffn_block_int8.launches, TF.mlp2_int8.launches,
            TC.ffn_gemm1.launches) == launches
