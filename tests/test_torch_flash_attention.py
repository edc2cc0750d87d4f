"""PyTorch port: the one-pass and streaming attention of
hriemo_torch/ops/flash_attention.py against the JAX Pallas kernels
``_onepass_impl`` and ``_pallas_mha_fwd_impl`` in interpret mode (CPU).
Shapes and tolerances as in tests/test_flash_attention.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hriemo.core.masking import NEG_INF
from hriemo.ops import flash_attention as JF
from hriemo.ops import flash_attention_pallas as JP
from hriemo_torch.ops import flash_attention as TF

from torch_port_helpers import assert_kernel_close, one_torch_thread  # noqa: F401


def _qkv(b=2, h=4, lq=140, lk=130, hd=64, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    return mk(b, h, lq, hd), mk(b, h, lk, hd), mk(b, h, lk, hd)


def _bias(lk, masked):
    bias = np.zeros((2, lk), np.float32)
    if masked:
        bias[0, lk - 30:] = NEG_INF
        bias[1, 17:] = NEG_INF
    return bias


KERNELS = {"onepass": (JP._onepass_impl, TF.onepass_attention),
           "streaming": (JP._pallas_mha_fwd_impl, TF.streaming_attention)}


# head dims beside 64: the tile instances 32, 128, 192 and 256 of the
# card's kernels, and 40 and 136, which they zero-pad to 64 and 192
WIDE_HEAD_DIMS = (32, 40, 128, 136, 192, 256)
SHAPES = [pytest.param(lq, lk, 64, id=f"{lq}-{lk}") for lq, lk in ((140, 130), (130, 300))] + [
    pytest.param(130, 300, hd, id=f"130-300-hd{hd}") for hd in WIDE_HEAD_DIMS]


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("lq,lk,hd", SHAPES)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_matches_pallas_kernel(kernel, lq, lk, hd, masked, dtype):
    jax_fn, torch_fn = KERNELS[kernel]
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    q, k, v = _qkv(lq=lq, lk=lk, hd=hd, seed=lq + lk + masked + (hd != 64) * hd)
    bias = _bias(lk, masked)
    ref = np.asarray(jax_fn(*(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(bias)),
                     np.float32)
    got = torch_fn(*(torch.from_numpy(a).to(dtype) for a in (q, k, v)), torch.from_numpy(bias))
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)
    else:  # 3e-2 as the JAX bf16 test, and the kernel tests' median
        assert_kernel_close(got, ref, atol=3e-2, rtol=0)


@pytest.mark.parametrize("kernel,hd", [pytest.param(kernel, 64, id=kernel)
                                       for kernel in sorted(KERNELS)] + [
    pytest.param(kernel, hd, id=f"{kernel}-hd{hd}")
    for kernel in sorted(KERNELS) for hd in WIDE_HEAD_DIMS])
def test_fully_masked_rows_finite(kernel, hd):
    q, k, v = (torch.from_numpy(a) for a in _qkv(hd=hd, seed=3))
    out = KERNELS[kernel][1](q, k, v, torch.full((2, 130), NEG_INF))
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("lk,route", [(256, "onepass"), (257, "streaming")])
def test_dispatch_at_onepass_max_lk(monkeypatch, lk, route):
    """flash_mha takes the one-pass kernel up to ONEPASS_MAX_LK keys and the
    streaming one beyond, in both packages (the limit lowered to 256 in
    both, so the shapes stay small)."""
    monkeypatch.setattr(JP, "ONEPASS_MAX_LK", 256)
    monkeypatch.setattr(TF, "ONEPASS_MAX_LK", 256)
    seen = []
    for name in ("onepass_attention_plain", "streaming_attention_plain"):
        fn = getattr(TF, name)
        monkeypatch.setattr(TF, name, lambda *a, _f=fn, _n=name: seen.append(_n) or _f(*a))
    q, k, v = _qkv(lq=130, lk=lk, seed=lk)
    mask = np.zeros((2, lk), bool)
    mask[1, 200:] = True
    ref = JP.pallas_mha(*(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(mask))
    got = TF.flash_mha(*(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(mask))
    assert seen == [f"{route}_attention_plain"]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)
    plain = TF.flash_mha_plain(*(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(mask))
    torch.testing.assert_close(plain, got, atol=0, rtol=0)


@pytest.mark.parametrize("lq,lk,hd", [(1024, 1024, 96), (1023, 1024, 96), (1024, 1023, 96),
                                      (2249, 2249, 96), (1024, 1024, 260), (1024, 1024, 12)])
def test_gate_matches_jax_shape_conditions(monkeypatch, lq, lk, hd):
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    q_shape, k_shape = (2, 8, lq, hd), (2, 8, lk, hd)
    assert TF.use_flash(q_shape, k_shape) == JF._use_pallas(q_shape, k_shape)



# fp32 at the wide tiles' head dims with q and k scaled so that the scores
# reach about +-30 (the regime of the card's fp32 test), at ONEPASS_MAX_LK
# keys on the one-pass kernel and one past it on the streaming one: the
# plain versions that the card holds its 3xTF32 kernels to, against the
# Pallas kernels at the card's fp32 limit (chip_smoke.py ATTN_TOL[fp32]:
# 1e-4, fp32 sums in another order)
@pytest.mark.parametrize("kernel,lk", [("onepass", JP.ONEPASS_MAX_LK),
                                       ("streaming", JP.ONEPASS_MAX_LK + 1)])
@pytest.mark.parametrize("hd", [192, 256])
def test_fp32_wide_head_dims_at_large_scores(kernel, lk, hd):
    jax_fn, torch_fn = KERNELS[kernel]
    q, k, v = _qkv(h=1, lq=70, lk=lk, hd=hd, seed=hd + lk)
    q, k = q * 2.5, k * 2.5
    bias = _bias(lk, masked=True)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    assert TF.scaled_scores(qt, kt).abs().max().item() > 25
    ref = np.asarray(jax_fn(*(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(bias)))
    got = torch_fn(qt, kt, vt, torch.from_numpy(bias))
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-4)


# ---- the streaming core's route (ops/flash_attention.py streaming_kernel): a
# pure function of the shape, pinned here; the card's readings behind its
# constants are in its comment, and tests/test_torch_cuda.py holds the pick
# to the fastest kernel on the card
BF16, FP16 = torch.bfloat16, torch.float16
# (lk, hd, B, H, kernel): phase 3's row-8 shapes (45 s clips, the uncapped
# MOSEI eval at 4, 8, 2 and 1 heads, the 4-head decoder), and the thin grids
# where a wave of blocks decides
STREAMING_PICKS = [(2249, 96, 2, 8, "wgmma"), (2267, 64, 16, 4, "wgmma"),
                   (2267, 32, 16, 8, "wgmma"), (2267, 128, 16, 2, "wgmma"),
                   (2267, 40, 16, 8, "wgmma"), (2249, 192, 2, 4, "wgmma_split"),
                   (2267, 256, 16, 1, "wgmma_split"), (2249, 136, 2, 4, "wgmma_split"),
                   (2049, 64, 2, 4, "mma"), (2560, 64, 2, 4, "wgmma"),
                   (2249, 96, 1, 8, "wgmma"), (2249, 128, 1, 2, "wgmma_split"),
                   (2249, 128, 2, 2, "wgmma"), (2249, 128, 4, 2, "wgmma_split"),
                   (2249, 128, 32, 2, "wgmma"), (2049, 128, 2, 2, "wgmma_split"),
                   (4096, 128, 2, 2, "wgmma"), (2249, 104, 16, 2, "wgmma"),
                   (2249, 256, 32, 1, "wgmma_split"), (2249, 192, 1, 4, "wgmma_split")]


@pytest.mark.parametrize("lk,hd,b,h,want", STREAMING_PICKS)
@pytest.mark.parametrize("dtype", [BF16, FP16])
def test_streaming_kernel_picks(lk, hd, b, h, want, dtype):
    assert TF.streaming_kernel(lk, hd, dtype, b=b, h=h) == want


@pytest.mark.parametrize("hd", [8, 32, 40, 64, 96, 104, 128, 136, 192, 200, 256])
def test_streaming_kernels_by_head_dim(hd):
    """"wgmma" at every instance up to 128, "wgmma_split" at 128-256 (hd
    104-256), both in bf16 and fp16 only; fp32 keeps "mma" alone."""
    want = ("mma", *(("wgmma",) if hd <= 128 else ()), *(("wgmma_split",) if hd > 96 else ()))
    for dtype in (BF16, FP16):
        assert TF.streaming_kernels(hd, dtype) == want
    assert TF.streaming_kernels(hd, torch.float32) == ("mma",)
    assert TF.streaming_kernel(2249, hd, torch.float32, b=16, h=4) == "mma"


@pytest.mark.parametrize("hd", [12, 260])
def test_streaming_kernel_off_the_instances(hd):
    """A head dim no instance takes (not a multiple of 8, or past 256) is
    left to "mma", whose launch refuses it."""
    assert TF.streaming_kernels(hd, BF16) == ("mma",)
    assert TF.streaming_kernel(2249, hd, BF16, b=2, h=8) == "mma"


def test_streaming_kernel_needs_views_tma_describes():
    """A view whose strides are not whole 16-byte steps stays on "mma",
    decided from the strides before any launch; head views of a [B, L,
    H*hd] projection are described."""
    good, bad = (2249 * 768, 96, 768) * 3, (2249 * 772, 96, 772) * 3
    assert TF.streaming_kernel(2249, 96, BF16, good, b=2, h=8) == "wgmma"
    assert TF.streaming_kernel(2249, 96, BF16, bad, b=2, h=8) == "mma"
    assert TF.streaming_kernel(2249, 192, FP16, bad[:3] * 3, b=2, h=4) == "mma"
    heads = lambda t: t.view(2, 2249, 8, 96).transpose(1, 2)
    q = heads(torch.zeros(2, 2249, 768, dtype=BF16))
    assert TF.streaming_route(q, q, q) == "wgmma"
    padded = heads(torch.zeros(2, 2249, 772, dtype=BF16)[..., :768])
    assert TF.streaming_route(padded, q, q) == "mma"


@pytest.mark.parametrize("kernel", [None, *TF.STREAMING_KERNELS])
def test_streaming_cpu_tensors_take_the_plain_version_whatever_the_kernel(kernel):
    q, k, v = (torch.from_numpy(a) for a in _qkv(lq=140, lk=300, seed=5))
    bias = torch.from_numpy(_bias(300, True))
    before = dict(TF.streaming_attention.kernels), TF.streaming_attention.launches
    got = TF.streaming_attention(q, k, v, bias, kernel)
    torch.testing.assert_close(got, TF.streaming_attention_plain(q, k, v, bias), atol=0, rtol=0)
    assert (dict(TF.streaming_attention.kernels), TF.streaming_attention.launches) == before
