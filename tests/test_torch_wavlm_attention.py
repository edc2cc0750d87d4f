"""PyTorch port: the fused WavLM gated-bias attention
(hriemo_torch/ops/wavlm_attention.py) against the JAX Pallas kernel
``_fused_impl`` in interpret mode (CPU). Inputs as in
tests/test_wavlm_attention_kernel.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hriemo.ops import wavlm_attention as JW
from hriemo_torch.ops import wavlm_attention as TW

from torch_port_helpers import assert_kernel_close, one_torch_thread  # noqa: F401


def _inputs(b=2, h=4, l=140, hd=32, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v = mk(b, h, l, hd), mk(b, h, l, hd), mk(b, h, l, hd)
    gate = rng.uniform(0.5, 2.0, size=(b, h, l)).astype(np.float32)
    pos = mk(h, l, l) * 0.1
    kpb = np.zeros((b, l), np.float32)
    kpb[1, 100:] = -1e9
    return q, k, v, gate, pos, kpb


def _run_both(args, dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    q, k, v, gate, pos, kpb = args
    ref = JW._fused_impl(*(jnp.asarray(a, jdt) for a in (q, k, v, gate, pos)), jnp.asarray(kpb))
    got = TW.wavlm_fused_attention(*(torch.from_numpy(a).to(dtype) for a in (q, k, v, gate, pos)),
                                   torch.from_numpy(kpb))
    assert got.dtype == dtype and got.shape == q.shape
    return got, np.asarray(ref, np.float32)


@pytest.mark.parametrize("l", [140, 130])
def test_plain_matches_pallas_kernel_fp32(l):
    got, ref = _run_both(_inputs(l=l), torch.float32)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)


@pytest.mark.parametrize("l", [140, 130])
def test_plain_matches_pallas_kernel_bf16(l):
    got, ref = _run_both(_inputs(l=l, seed=l), torch.bfloat16)
    assert_kernel_close(got, ref)


def test_fully_masked_keys_finite():
    q, k, v, gate, pos, _ = _inputs(l=128)
    kpb = np.full((2, 128), -1e9, np.float32)
    out = TW.wavlm_fused_attention(*(torch.from_numpy(a) for a in (q, k, v, gate, pos, kpb)))
    assert torch.isfinite(out).all()
    assert TW.wavlm_fused_attention.launches == 0  # CPU tensors: the plain version


@pytest.mark.parametrize("l,hd", [(127, 64), (128, 64), (2048, 64), (2049, 64),
                                  (499, 96), (499, 260), (499, 12), (1499, 256)])
def test_gate_matches_jax_shape_conditions(monkeypatch, l, hd):
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    assert TW.use_fused(l, hd) == JW.use_fused(l, hd)
