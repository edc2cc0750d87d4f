"""PyTorch port: fp16 on the flash route and the WavLM core's gradient,
against the JAX package on the CPU.

* fp16 ``flash_mha`` (its plain versions here: ``onepass_attention_plain``
  up to 2048 keys, ``streaming_attention_plain`` beyond) against JAX's
  ``flash_mha`` with its ``_use_pallas`` gate monkeypatched on, so that the
  one-pass and streaming Pallas kernels run in interpret mode, fp16 as JAX
  runs them (fp32 scores and sums, ``p / l`` or ``p`` cast to v's dtype).
  Held at atol 2.5e-4 and rtol 1e-3 (about two fp16 steps at these
  outputs, |out| < 0.25) with a median below 2e-5: the two read at most
  6.1e-5, median 0, while the same inputs through bf16 read 1.1e-3,
  median 9.2e-5, so a p rounded to bf16 instead of fp16 fails both.
* ``wavlm_fused_attention``'s gradients in q, k, v, gate and position_bias
  (the recompute through the plain version) against ``jax.grad`` through
  the JAX ``custom_vjp`` at 1e-5 in fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hriemo.ops import flash_attention as JF
from hriemo.ops import wavlm_attention as JW
from hriemo_torch.ops import flash_attention as TF
from hriemo_torch.ops import wavlm_attention as TW

from torch_port_helpers import np32, one_torch_thread  # noqa: F401

FP16_ATOL, FP16_RTOL, FP16_MEDIAN = 2.5e-4, 1e-3, 2e-5


@pytest.mark.parametrize("lk,route", [(2048, "onepass"), (2100, "streaming")])
def test_fp16_flash_matches_jax_kernels(monkeypatch, lk, route):
    monkeypatch.setattr(JF, "_use_pallas", lambda q_shape, k_shape: True)
    rng = np.random.default_rng(lk)
    q, k, v = (rng.standard_normal((2, 2, n, 64)).astype(np.float32) for n in (72, lk, lk))
    mask = np.zeros((2, lk), bool)
    mask[1, lk - 333:] = True  # a padded key row: element 1's last 333 keys
    seen = []
    fn = getattr(TF, f"{route}_attention_plain")
    monkeypatch.setattr(TF, f"{route}_attention_plain", lambda *a: seen.append(1) or fn(*a))
    ref = np.asarray(JF.flash_mha(*(jnp.asarray(a, jnp.float16) for a in (q, k, v)),
                                  jnp.asarray(mask)), np.float32)
    got = TF.flash_mha(*(torch.from_numpy(a).half() for a in (q, k, v)), torch.from_numpy(mask))
    assert seen and got.dtype == torch.float16 and got.shape == q.shape
    d = np.abs(np32(got) - ref)
    np.testing.assert_allclose(np32(got), ref, atol=FP16_ATOL, rtol=FP16_RTOL)
    assert np.median(d) < FP16_MEDIAN, np.median(d)


@pytest.mark.parametrize("l", [130, 160])
def test_wavlm_fused_attention_gradient_matches_jax(l):
    rng = np.random.default_rng(l)
    b, h, hd = 2, 3, 16
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, k, v, pos = mk(b, h, l, hd), mk(b, h, l, hd), mk(b, h, l, hd), mk(h, l, l) * 0.3
    gate = rng.uniform(0.5, 2.0, size=(b, h, l)).astype(np.float32)
    kpb = np.zeros((b, l), np.float32)
    kpb[1, l - 37:] = -1e9
    g_out = mk(b, h, l, hd)

    def loss(*xs):
        return jnp.sum(JW.wavlm_fused_attention(*xs, jnp.asarray(kpb)) * g_out)

    ref = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(a) for a in (q, k, v, gate, pos)))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v, gate, pos)]
    out = TW.wavlm_fused_attention(*ins, torch.from_numpy(kpb))
    got = torch.autograd.grad(out, ins, torch.from_numpy(g_out))
    for name, g, r in zip(("q", "k", "v", "gate", "position_bias"), got, ref):
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, rtol=1e-5,
                                   err_msg=name)
