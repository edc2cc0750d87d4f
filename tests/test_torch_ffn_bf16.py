"""PyTorch port: the float fused FFN block (hriemo_torch/ops/fused_ffn.py
ffn_block_bf16) against the JAX Pallas kernel ``_kernel_bf16`` in
interpret mode (CPU), forward and gradient, at the widths and tolerances of
tests/test_fused_ffn.py; and the fp32 block with its products computed as
the card computes them (3xTF32), at WavLM's widths."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hriemo.ops import fused_ffn as JF
from hriemo_torch.nn.layers import LayerNorm, Linear
from hriemo_torch.ops import fused_ffn as TF

from torch_port_helpers import (assert_kernel_close, matmul_1xtf32, matmul_3xtf32,  # noqa: F401
                                one_torch_thread, tf32_truncate)

D, F, M = 128, 256, 48


@pytest.fixture(scope="module")
def ffn():
    rng = np.random.default_rng(0)  # tests/test_fused_ffn.py's inputs
    return (rng.standard_normal((M, D)).astype(np.float32) * 0.5,
            rng.standard_normal((F, D)).astype(np.float32) * 0.05,
            rng.standard_normal((F,)).astype(np.float32) * 0.02,
            rng.standard_normal((D, F)).astype(np.float32) * 0.05,
            rng.standard_normal((D,)).astype(np.float32) * 0.02,
            1.0 + rng.standard_normal((D,)).astype(np.float32) * 0.1,
            rng.standard_normal((D,)).astype(np.float32) * 0.1)


def _torch(arrs, dtype=torch.float32):
    x, *rest = (torch.from_numpy(a) for a in arrs)
    return (x.to(dtype), rest[0].to(dtype), rest[1], rest[2].to(dtype), *rest[3:])


@pytest.mark.parametrize("rows", [M, 41])  # 41: not a multiple of the TPU block
@pytest.mark.parametrize("fast_gelu", [True, False])
def test_fp32_matches_pallas_kernel(ffn, rows, fast_gelu):
    arrs = (ffn[0][:rows], *ffn[1:])
    ref = JF.ffn_block_bf16(*map(jnp.asarray, arrs), 1e-5, fast_gelu, 16)
    got = TF.ffn_block_bf16(*_torch(arrs), 1e-5, fast_gelu)
    assert got.shape == (rows, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4)
    assert TF.ffn_block_bf16.launches == 0  # CPU tensors take the plain version


def test_bf16_matches_pallas_kernel(ffn):
    """bf16: the plain version follows the kernel's order (x . W1 summed in
    fp32 before b1), not _xla_reference's (rounded to bf16 first)."""
    jx = [jnp.asarray(a) for a in ffn]
    ref = JF.ffn_block_bf16(jx[0].astype(jnp.bfloat16), jx[1].astype(jnp.bfloat16), jx[2],
                            jx[3].astype(jnp.bfloat16), *jx[4:], 1e-5, True, 16)
    got = TF.ffn_block_bf16(*_torch(ffn, torch.bfloat16), 1e-5, True)
    assert got.dtype == torch.bfloat16
    assert_kernel_close(got, np.asarray(ref, np.float32))


def test_gradient_matches_jax(ffn):
    """The backward recomputes through the unfused reference, as the JAX
    custom VJP does (tests/test_fused_ffn.py:60-73)."""
    jx = [jnp.asarray(a) for a in ffn]

    def loss(x, w1):
        return jnp.sum(JF.ffn_block_bf16(x, w1, *jx[2:], 1e-5, True, 16) ** 2)

    gx_ref, gw_ref = jax.grad(loss, argnums=(0, 1))(jx[0], jx[1])
    x, w1, *rest = _torch(ffn)
    x.requires_grad_(True)
    w1.requires_grad_(True)
    (TF.ffn_block_bf16(x, w1, *rest, 1e-5, True) ** 2).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx_ref), atol=1e-3)
    np.testing.assert_allclose(w1.grad.numpy(), np.asarray(gw_ref), atol=1e-3)


def test_routing_is_per_op_unless_forced(ffn, monkeypatch):
    """route_ffn_block keeps the JAX routing (float FFNs per op); forced to
    the fused block it gives the same result at fp32."""
    x, w1, b1, w2, b2, g, b = _torch(ffn)
    p_in, p_out, ln = Linear(D, F), Linear(F, D), LayerNorm(D)
    with torch.no_grad():
        for t, v in ((p_in.weight, w1), (p_in.bias, b1), (p_out.weight, w2),
                     (p_out.bias, b2), (ln.weight, g), (ln.bias, b)):
            t.copy_(v)
        x3 = x.reshape(3, 16, D)
        assert not TF.use_ffn_bf16(D, F)
        calls = []
        monkeypatch.setattr(TF, "ffn_block_bf16_plain",
                            lambda *a, _f=TF.ffn_block_bf16_plain: calls.append(1) or _f(*a))
        routed = TF.route_ffn_block(p_in, p_out, ln, x3, 1e-5, True, None, use_kernels=False)
        assert not calls
        monkeypatch.setattr(TF, "use_ffn_bf16", lambda d, f: True)
        forced = TF.route_ffn_block(p_in, p_out, ln, x3, 1e-5, True, None, use_kernels=False)
    assert calls == [1]
    np.testing.assert_allclose(forced.numpy(), routed.numpy(), atol=2e-5)


def _wavlm_widths(rows=16, d=768, f=3072):
    """Inputs at WavLM's FFN widths, scaled as the fixture's."""
    rng = np.random.default_rng(1)
    return (rng.standard_normal((rows, d)).astype(np.float32) * 0.5,
            rng.standard_normal((f, d)).astype(np.float32) * 0.05,
            rng.standard_normal((f,)).astype(np.float32) * 0.02,
            rng.standard_normal((d, f)).astype(np.float32) * 0.05,
            rng.standard_normal((d,)).astype(np.float32) * 0.02,
            1.0 + rng.standard_normal((d,)).astype(np.float32) * 0.1,
            rng.standard_normal((d,)).astype(np.float32) * 0.1)


def _ffn_with(matmul, x, w1, b1, w2, b2, g, b, fast_gelu):
    """The fp32 block in the kernel's order, its two products by ``matmul``."""
    h = TF.gelu_fp32(matmul(x, w1.t()) + b1, fast_gelu)
    return TF.layer_norm_rows((x + matmul(h, w2.t())) + b2, g, b, 1e-5)


def test_tf32_split_is_exact():
    """big + small is x exactly, and big is a TF32 value."""
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(4096).astype(np.float32)) * 37
    big = tf32_truncate(x)
    assert torch.equal(big + (x - big), x)
    assert not (big.view(torch.int32) & 8191).any()
    assert torch.equal(tf32_truncate(big), big)


@pytest.mark.parametrize("fast_gelu", [True, False])
def test_3xtf32_products_match_pallas_kernel(fast_gelu):
    """fp32 at WavLM's widths (768 -> 3072 -> 768), the two products as the
    card's 3xTF32 GEMM computes them: within 2e-4 of the Pallas kernel, the
    fp32 tolerance of the card tests (readings ~3e-6)."""
    arrs = _wavlm_widths()
    ref = np.asarray(JF.ffn_block_bf16(*map(jnp.asarray, arrs), 1e-5, fast_gelu, 16))
    got = _ffn_with(matmul_3xtf32, *map(torch.from_numpy, arrs), fast_gelu)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=0)


def test_one_tf32_product_misses_fp32_tolerance():
    """One TF32 product, at the same inputs, misses that 2e-4 (reading
    ~2.9e-3): the reason the fp32 GEMM takes three."""
    arrs = _wavlm_widths()
    ref = np.asarray(JF.ffn_block_bf16(*map(jnp.asarray, arrs), 1e-5, True, 16))
    got = _ffn_with(matmul_1xtf32, *map(torch.from_numpy, arrs), True)
    assert np.abs(got.numpy() - ref).max() > 2e-4
