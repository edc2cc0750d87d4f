"""PyTorch port: the fused WavLM conv stack (hriemo_torch/ops/conv_stack.py)
against the JAX Pallas kernels in interpret mode (CPU), each plain stage
against the port's routed feature encoder, and the routing gate. The
base-plus conv pattern at 128 channels and the tolerances of
tests/test_conv_stack.py."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hriemo.frontends import WavLMConfig, WavLMEncoder
from hriemo.ops.conv_stack import _conv_k2s2, _conv_k3s2
from hriemo.ops.conv_stack import conv_stack_fused as jax_conv_stack
import hriemo_torch.frontends as TF
from hriemo_torch.nn.layers import gelu
from hriemo_torch.ops import conv_stack as CS
from hriemo_torch.ops.fused_ffn import gelu_fp32

from torch_port_helpers import flat, one_torch_thread, same_config  # noqa: F401
from hriemo_torch.utils.convert import load_flat_params

CFG = dataclasses.replace(WavLMConfig.base_plus(), conv_dim=(128,) * 7, fast_gelu=True,
                          hidden_size=128, num_hidden_layers=1, num_attention_heads=2)


@pytest.fixture(scope="module")
def encoders():
    jm = WavLMEncoder(CFG)
    tm = load_flat_params(TF.WavLMEncoder(same_config(TF.WavLMConfig, CFG)), flat(jm.params))
    return jm, tm.eval()


def _wave(seed, b, tw):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, tw)).astype(np.float32) * 0.3


@pytest.mark.parametrize("tw", [
    16000,          # 1.0 s -> 49 frames
    40000,          # 2.5 s -> 124 frames
    10240 + 400,    # tests/test_conv_stack.py's tile-tail length
])
def test_matches_pallas_kernels(encoders, tw):
    jm, tm = encoders
    wave = _wave(tw, 2, tw)
    ref = jax_conv_stack(jm.params["feature_extractor"], jnp.asarray(wave), CFG)
    with torch.no_grad():
        got = CS.conv_stack_fused(tm.feature_extractor, torch.from_numpy(wave), tm.config)
    assert got.shape == ref.shape == (2, CS.conv_lengths(tw)[6], 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4, rtol=2e-3)
    assert CS.conv_stack_stats.launches == CS.conv_stack_k1.launches == 0
    assert CS.conv_stack_k2.launches == 0


def _routed(tm, wave):
    """The routed feature encoder's output and, from hooks, its conv0 and
    conv3 activations ([B, T, C], conv3 after its GELU)."""
    seen = {}
    convs = tm.feature_extractor.conv_layers
    hooks = [convs[i].conv.register_forward_hook(
        lambda m, a, out, i=i: seen.__setitem__(i, out.transpose(1, 2))) for i in (0, 3)]
    try:
        out = tm._feature_encoder(wave)
    finally:
        for h in hooks:
            h.remove()
    return out, seen[0], gelu(seen[3], True)


def test_each_stage_matches_routed_encoder(encoders):
    _, tm = encoders
    wave = torch.from_numpy(_wave(11, 3, 12345))
    w0, gn_w, gn_b, *taps = CS.stack_operands(tm.feature_extractor, torch.float32)
    with torch.no_grad():
        out, x0, x3 = _routed(tm, wave)
        stats = CS.conv_stack_stats(wave, w0)
        ref_stats = torch.stack([x0.sum(1), (x0 * x0).sum(1)], 1)
        np.testing.assert_allclose(stats.numpy(), ref_stats.numpy(), rtol=1e-4, atol=1e-2)
        got3 = CS.conv_stack_k1(wave, stats, w0, gn_w, gn_b, *taps[:3], CFG.layer_norm_eps, True)
        np.testing.assert_allclose(got3.numpy(), x3.numpy(), atol=2e-4, rtol=2e-3)
        got = CS.conv_stack_k2(x3.contiguous(), *taps[3:], True)
    np.testing.assert_allclose(got.numpy(), out.numpy(), atol=2e-4, rtol=2e-3)


def test_bf16_close_to_fp32_route(encoders):
    """bf16 inputs stay within the serving envelope of the fp32 route."""
    _, tm = encoders
    wave = torch.from_numpy(_wave(7, 2, 16000))
    with torch.no_grad():
        ref = tm._feature_encoder(wave)
        got = CS.conv_stack_fused(tm.feature_extractor, wave.to(torch.bfloat16), tm.config)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref.numpy(), atol=0.15, rtol=0.15)


def test_gate_is_off_and_forcing_it_keeps_the_encoder(encoders, monkeypatch):
    _, tm = encoders
    for cfg in (TF.WavLMConfig.base_plus(), TF.WavLMConfig.tiny(), tm.config):
        assert not CS.use_conv_stack(cfg, tm.feature_extractor)
    wave = torch.from_numpy(_wave(5, 2, 16000))
    mask = torch.ones(2, 16000, dtype=torch.int32)
    mask[1, 9000:] = 0
    calls = []
    monkeypatch.setattr(CS, "conv_stack_k2_plain",
                        lambda *a, _f=CS.conv_stack_k2_plain: calls.append(1) or _f(*a))
    with torch.no_grad():
        routed, fm = tm(wave, mask)
        assert not calls
        monkeypatch.setattr(CS, "use_conv_stack", lambda cfg, fe: True)
        forced, fm_forced = tm(wave, mask)
    assert calls == [1]
    np.testing.assert_array_equal(fm.numpy(), fm_forced.numpy())
    np.testing.assert_allclose(forced.numpy(), routed.numpy(), atol=2e-4, rtol=2e-3)


def _bf16_steps(got, ref):
    """|got - ref| in bf16 steps at the larger of the two magnitudes, taken
    at 1/16 at least: GELU's tail maps large negative sums to outputs near 0,
    where fp32 sums in another order move the output by ~1e-7 (many steps of
    a value of 1e-6)."""
    a, r = got.float().numpy(), np.asarray(ref, np.float32)
    mag = np.maximum(np.maximum(np.abs(a), np.abs(r)), 1.0 / 16)
    return np.abs(a - r) / 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [40, 41])
@pytest.mark.parametrize("k", [3, 2])
def test_strided_view_conv_matches_jax(k, t, dtype):
    """The view the card's K1 convs read (conv_rows: rows 2C apart, K = k*C,
    tap j at K-offset j*C) times the tap-major weights gives the JAX
    kernels' stride-2 convs (_conv_k3s2 / _conv_k2s2, which take an even T:
    odd T gets one zero row, whose output row is not a valid row) and the
    port's tap-by-tap _conv_s2: fp32 at 1e-5, bf16 within one step."""
    rng = np.random.default_rng(100 * k + t)
    c = 64
    x = rng.standard_normal((1, t, c)).astype(np.float32)
    taps = rng.standard_normal((k, c, c)).astype(np.float32) * 0.1
    xt = torch.from_numpy(x).to(dtype)
    tt = torch.from_numpy(taps).to(dtype)
    rows = CS.conv_rows(xt, k)
    t_out = (t - k) // 2 + 1
    assert rows.shape == (1, t_out, k * c) and rows.stride() == (t * c, 2 * c, 1)
    assert rows.data_ptr() == xt.data_ptr()  # a view, not a copy
    np.testing.assert_array_equal(rows[0, 1].float().numpy(),
                                  xt[0, 2:2 + k].reshape(-1).float().numpy())
    # the tap-major weights read as [C_out, k*C_in], as the card's GEMM does
    w = tt.permute(1, 0, 2).reshape(c, k * c)
    got = gelu_fp32(rows.float() @ w.float().t(), True).to(dtype)

    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    xj = jnp.asarray(np.pad(x[0], ((0, t % 2), (0, 0)))).astype(jdt)
    wj = [jnp.asarray(taps[j].T).astype(jdt) for j in range(k)]
    ref = _conv_k3s2(xj, *wj, True) if k == 3 else _conv_k2s2(xj, jnp.concatenate(wj), True)
    ref = np.asarray(ref.astype(jnp.float32))[None, :t_out]
    port = CS._conv_s2(xt, tt, True).float().numpy()
    assert got.dtype == dtype and got.shape == port.shape == ref.shape
    for want in (ref, port):
        if dtype == torch.float32:
            np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
        else:
            assert _bf16_steps(got, want).max() <= 1.0
