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

