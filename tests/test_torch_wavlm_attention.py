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


# ---- the one-pass core's route (ops/wavlm_attention.py onepass_kernel): a
# pure function of the shape, pinned here; the card's readings behind its
# constants are in its comment, and tests/test_torch_cuda.py holds the pick
# to the fastest kernel on the card
BF16, FP16 = torch.bfloat16, torch.float16


@pytest.mark.parametrize("lk", [1, 63, 64, 65, 128, 129, 256, 257, 511, 512])
@pytest.mark.parametrize("hd", [64, 96])
@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("dtype", [BF16, FP16])
def test_onepass_kernel_holds_every_score_up_to_512_keys(lk, hd, gated, dtype):
    for b in (1, 64):
        assert TW.onepass_kernel(lk, hd, gated, dtype, b=b, h=12) == "wgmma"
    assert TW.onepass_kernels(lk, hd, gated, dtype) == ("mma", "wgmma", "wgmma_sweeps")


# past 512 keys: (lk, hd, gated, B, H, kernel) at the edges of the sweeps'
# waves (128-row blocks over 132 SMs) and the wide tiles' rounds
PAST_512 = [(513, 64, True, 4, 12, "wgmma_sweeps"), (513, 96, False, 4, 8, "mma"),
            (768, 64, True, 4, 12, "wgmma_sweeps"), (1024, 96, False, 4, 8, "wgmma_sweeps"),
            (1499, 64, True, 2, 12, "wgmma_sweeps"), (1499, 64, True, 1, 12, "mma"),
            (1499, 96, False, 2, 8, "mma"), (1499, 96, False, 3, 8, "wgmma_sweeps"),
            (1951, 64, False, 16, 4, "wgmma_sweeps"), (2048, 64, True, 4, 12, "wgmma_sweeps"),
            (2048, 96, False, 1, 8, "mma"), (2049, 64, True, 64, 12, "mma"),
            (2049, 96, False, 64, 8, "mma"),
            (1499, 192, False, 2, 4, "wgmma_sweeps"), (1499, 136, False, 2, 4, "wgmma_sweeps"),
            (1499, 192, False, 1, 4, "mma"), (512, 192, False, 4, 4, "mma"),
            (128, 192, False, 4, 4, "mma"), (1499, 192, False, 3, 4, "wgmma_sweeps"),
            (1951, 256, False, 16, 1, "wgmma_sweeps"), (1951, 256, False, 12, 1, "mma"),
            (1951, 256, False, 8, 1, "wgmma_sweeps"), (2048, 256, False, 4, 1, "mma"),
            (1499, 200, False, 2, 4, "wgmma_sweeps"), (1499, 256, False, 4, 4, "mma"),
            (2049, 256, False, 16, 1, "mma")]


@pytest.mark.parametrize("lk,hd,gated,b,h,want", PAST_512)
@pytest.mark.parametrize("dtype", [BF16, FP16])
def test_onepass_kernel_past_512_keys_and_wide_tiles(lk, hd, gated, b, h, want, dtype):
    assert TW.onepass_kernel(lk, hd, gated, dtype, b=b, h=h) == want


@pytest.mark.parametrize("hd", [32, 40, 128, 136, 192, 256, 64, 96])
@pytest.mark.parametrize("lk", [65, 499, 1499])
def test_onepass_kernel_keeps_mma(hd, lk):
    """fp32 at every head dim, the 16-bit types at 32, 40 and 128, and the
    gate on the wide tiles stay on the mma.sync kernels."""
    for gated in (True, False):
        assert TW.onepass_kernel(lk, hd, gated, torch.float32, b=64, h=12) == "mma"
        assert TW.onepass_kernels(lk, hd, gated, torch.float32) == ("mma",)
    for dtype in (BF16, FP16):
        if hd in (32, 40, 128):
            assert TW.onepass_kernel(lk, hd, False, dtype, b=64, h=12) == "mma"
        if hd > 128:
            assert TW.onepass_kernel(lk, hd, True, dtype, b=64, h=12) == "mma"


def test_onepass_kernel_needs_views_tma_describes():
    """A view whose strides are not whole 16-byte steps stays on "mma",
    decided from the strides before any launch; head views of a [B, L,
    H*hd] projection, and size-1 dimensions (stride 0), are described."""
    assert TW.tma_view((499 * 768, 64, 768) * 3)
    assert TW.tma_view((0, 0, 64))
    assert not TW.tma_view((499 * 772, 64, 772) * 3)   # rows 1544 bytes apart
    assert not TW.tma_view((8, 4, 12))
    good, bad = (499 * 768, 64, 768) * 3, (499 * 772, 64, 772) * 3
    assert TW.onepass_kernel(499, 64, True, BF16, good, b=4, h=12) == "wgmma"
    assert TW.onepass_kernel(499, 64, True, BF16, bad, b=4, h=12) == "mma"
    assert TW.onepass_kernel(1951, 256, False, FP16, bad, b=16, h=1) == "mma"
    heads = lambda t: t.view(4, 499, 12, 64).transpose(1, 2)
    q = heads(torch.zeros(4, 499, 768, dtype=BF16))
    assert TW.onepass_route(q, q, q, True) == "wgmma"
    padded = heads(torch.zeros(4, 499, 772, dtype=BF16)[..., :768])
    assert TW.onepass_route(padded, q, q, True) == "mma"


@pytest.mark.parametrize("kernel", [None, *TW.ONEPASS_KERNELS])
def test_cpu_tensors_take_the_plain_version_whatever_the_kernel(kernel):
    q, k, v, gate, pos, kpb = (torch.from_numpy(a) for a in _inputs(l=130))
    before = dict(TW.wavlm_fused_attention.kernels)
    got = TW.wavlm_fused_attention(q, k, v, gate, pos, kpb, kernel)
    assert torch.equal(got, TW.wavlm_fused_attention_plain(q, k, v, gate, pos, kpb))
    assert dict(TW.wavlm_fused_attention.kernels) == before
