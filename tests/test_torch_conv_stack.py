"""PyTorch port: the fused WavLM conv stack (hriemo_torch/ops/conv_stack.py)
against the JAX Pallas kernels in interpret mode (CPU), each plain stage
against the port's routed feature encoder, the route rule, the prepared
operands, and the whole encoder with the route forced on against JAX's. The
base-plus conv pattern at 128 channels and the tolerances of
tests/test_conv_stack.py."""

import copy
import dataclasses
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hriemo.frontends import WavLMConfig, WavLMEncoder
from hriemo.ops.conv_stack import _conv_k2s2, _conv_k3s2
from hriemo.ops.conv_stack import conv_stack_fused as jax_conv_stack
import hriemo_torch.frontends as TF
from hriemo_torch.infer.streaming import MEASURED_BUCKET_BATCH
from hriemo_torch.nn.layers import gelu
from hriemo_torch.ops import conv_stack as CS
from hriemo_torch.ops.fused_ffn import gelu_fp32

from torch_port_helpers import flat, matmul_3xtf32, one_torch_thread, same_config  # noqa: F401
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


def _on_card(b, tw, dtype=torch.bfloat16):
    """What the route reads of a waveform on the card (shape, device,
    dtype), without one."""
    return types.SimpleNamespace(shape=(b, tw), device=torch.device("cuda"), dtype=dtype)


def test_gate_is_off_and_forcing_it_keeps_the_encoder(encoders, monkeypatch):
    """The rule: on the CPU the gate is off for every config (the cuDNN
    route's code, as in JAX); on the card it is on for the base-plus
    encoder's bf16 waveforms and off in fp32 and for a pattern or width the
    kernels do not take. Forced on, the port's encoder runs the fused stack
    (its plain versions here) and keeps the routed encoder's output."""
    _, tm = encoders
    wave = torch.from_numpy(_wave(5, 2, 16000))
    before = sum(CS.use_conv_stack.routes.values())
    for cfg in (TF.WavLMConfig.base_plus(), TF.WavLMConfig.tiny(), tm.config):
        assert not CS.use_conv_stack(cfg, tm.feature_extractor, wave)
        assert not CS.use_conv_stack(cfg, tm.feature_extractor, wave.to(torch.bfloat16))
        assert not CS.use_conv_stack(cfg, tm.feature_extractor, _on_card(2, 16000, torch.float32))
        assert CS.use_conv_stack(cfg, tm.feature_extractor, _on_card(2, 16000)) == (
            cfg == TF.WavLMConfig.base_plus())
    assert sum(CS.use_conv_stack.routes.values()) == before + 12
    assert CS.use_conv_stack.routes["fused", 2, 16000, "bfloat16"] >= 1
    mask = torch.ones(2, 16000, dtype=torch.int32)
    mask[1, 9000:] = 0
    calls = []
    monkeypatch.setattr(CS, "conv_stack_k2_plain",
                        lambda *a, _f=CS.conv_stack_k2_plain: calls.append(1) or _f(*a))
    with torch.no_grad():
        routed, fm = tm(wave, mask)
        assert not calls
        monkeypatch.setattr(CS, "use_conv_stack", lambda cfg, fe, wave: True)
        forced, fm_forced = tm(wave, mask)
    assert calls == [1]
    np.testing.assert_array_equal(fm.numpy(), fm_forced.numpy())
    np.testing.assert_allclose(forced.numpy(), routed.numpy(), atol=2e-4, rtol=2e-3)


@pytest.mark.parametrize("sec,b", sorted(MEASURED_BUCKET_BATCH.items()))
def test_route_rule_at_the_served_batches(sec, b):
    """The route as a pure function of (device type, dtype, B, Tw): the
    kernels for every served bf16 flush on the card; the cuDNN route on the
    CPU and in fp32."""
    tw = int(sec * 16000)
    assert CS.conv_stack_route("cuda", torch.bfloat16, b, tw) == "fused"
    assert CS.conv_stack_route("cpu", torch.bfloat16, b, tw) == "cudnn"
    assert CS.conv_stack_route("cuda", torch.float32, b, tw) == "cudnn"
    assert CS.conv_stack_route("cpu", torch.float32, b, tw) == "cudnn"


@pytest.mark.parametrize("b,tw,want", [
    (1, 400, "fused"),       # one output frame
    (1, 399, "cudnn"),       # none: the kernels refuse it
    (8, 160000, "fused"),
    (1, 16000, "fused"),
    (4, 60000, "fused"),
    (0, 16000, "cudnn"),
])
def test_route_rule_edges(b, tw, want):
    assert CS.conv_stack_route("cuda", torch.bfloat16, b, tw) == want
    assert CS.conv_stack_route("cuda", torch.float16, b, tw) == "cudnn"


def test_prepared_operands_kept_until_the_weights_change(encoders):
    """The stack's operands are taken once per weights and dtype: the same
    tensors on the next call, the same values as stack_operands; taken again
    after an in-place write to a weight and for another dtype."""
    _, tm = encoders
    fe = copy.deepcopy(tm.feature_extractor)
    first = CS.prepared_operands(fe, torch.float32)
    assert CS.prepared_operands(fe, torch.float32) is first
    for got, want in zip(first, CS.stack_operands(fe, torch.float32)):
        assert torch.equal(got, want)
    with torch.no_grad():
        fe.conv_layers[4].conv.weight.mul_(2.0)
    second = CS.prepared_operands(fe, torch.float32)
    assert second is not first
    assert torch.equal(second[6], CS.conv_taps(fe.conv_layers[4].conv.weight, torch.float32))
    assert torch.equal(second[6], 2.0 * first[6])
    third = CS.prepared_operands(fe, torch.bfloat16)
    assert [t.dtype for t in third] == [torch.bfloat16] + [torch.float32] * 2 + [
        torch.bfloat16] * 6
    assert CS.prepared_operands(fe, torch.bfloat16) is third


@pytest.mark.parametrize("tw", [16000, 40000])
def test_encoder_with_the_route_forced_matches_jax(encoders, monkeypatch, tw):
    """The port's whole WavLMEncoder forward with the conv-stack route
    forced on (its plain stats, K1 and K2 on the CPU) against JAX's WavLM
    forward with its gate forced on (the Pallas stack in interpret mode),
    fp32, one element padded: tests/test_conv_stack.py's 2e-4/2e-3."""
    import hriemo.ops.conv_stack as jax_cs

    jm, tm = encoders
    wave = _wave(tw + 3, 2, tw)
    mask = np.ones((2, tw), np.int32)
    mask[1, tw // 2 + 123:] = 0
    monkeypatch.setattr(jax_cs, "use_conv_stack", lambda cfg, params: True)
    monkeypatch.setattr(CS, "use_conv_stack", lambda cfg, fe, wave: True)
    ref, fm_ref = jm.apply(jm.params, jnp.asarray(wave), jnp.asarray(mask))
    calls = []
    monkeypatch.setattr(CS, "conv_stack_k2_plain",
                        lambda *a, _f=CS.conv_stack_k2_plain: calls.append(1) or _f(*a))
    with torch.no_grad():
        got, fm = tm(torch.from_numpy(wave), torch.from_numpy(mask))
    assert calls == [1]
    np.testing.assert_array_equal(fm.numpy(), np.asarray(fm_ref))
    assert got.shape == ref.shape == (2, CS.conv_lengths(tw)[6], CFG.hidden_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4, rtol=2e-3)


def _bf16_steps(got, ref):
    """|got - ref| in bf16 steps at the larger of the two magnitudes, taken
    at 1/16 at least: GELU's tail maps large negative sums to outputs near 0,
    where fp32 sums in another order move the output by ~1e-7 (many steps of
    a value of 1e-6)."""
    a, r = got.float().numpy(), np.asarray(ref, np.float32)
    mag = np.maximum(np.maximum(np.abs(a), np.abs(r)), 1.0 / 16)
    return np.abs(a - r) / 2.0 ** (np.floor(np.log2(mag)) - 7)


def _tma_tap_rows(x, k):
    """The rows of a stride-2 conv with ``k`` taps over ``x [B, T, C]`` as
    the bf16 TMA GEMM's tensor maps describe them (csrc/conv_stack.cu
    hr_conv_s2_tma, csrc/tma_gemm.cuh): map 0 is x's even rows, ceil(T / 2)
    of them, map 1 its odd rows, T // 2; tap j of output row r is row r + j
    // 2 of map j % 2, zeros past the map's rows. The k parts ``[B, t_out,
    C]``."""
    t_out = (x.shape[1] - k) // 2 + 1
    maps = (x[:, 0::2], x[:, 1::2])
    assert maps[0].shape[1] == -(-x.shape[1] // 2) and maps[1].shape[1] == x.shape[1] // 2
    parts = []
    for j in range(k):
        rows = maps[j % 2][:, j // 2:j // 2 + t_out]
        parts.append(torch.nn.functional.pad(rows, (0, 0, 0, t_out - rows.shape[1])))
    return parts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [40, 41, 255, 258, 259])
@pytest.mark.parametrize("k", [3, 2])
def test_strided_view_conv_matches_jax(k, t, dtype):
    """The view the card's K1 convs read (conv_rows: rows 2C apart, K = k*C,
    tap j at K-offset j*C) times the tap-major weights gives the JAX
    kernels' stride-2 convs (_conv_k3s2 / _conv_k2s2, which take an even T:
    odd T gets one zero row, whose output row is not a valid row) and the
    port's tap-by-tap _conv_s2: fp32 at 1e-5, bf16 within one step. So does
    the bf16 TMA GEMM's description of the same rows (_tma_tap_rows), and
    conv_gemm, which takes the plain version on the CPU. The TMA GEMM's 128-row tile: t = 255 gives
    127 output rows (one short of a tile, k = 2 and 3), 258 gives 128 (k =
    3) and 129 (k = 2), 259 gives 129 (one row past, k = 2 and 3; odd t, so
    the last row's third tap reads x's last row)."""
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
    taps_rows = torch.cat([part.float() for part in _tma_tap_rows(xt, k)], dim=-1)
    torch.testing.assert_close(taps_rows, rows.float(), atol=0, rtol=0)
    torch.testing.assert_close(CS.conv_gemm(xt, tt, True), CS._conv_s2(xt, tt, True),
                               atol=0, rtol=0)
    for want in (ref, port):
        if dtype == torch.float32:
            np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
        else:
            assert _bf16_steps(got, want).max() <= 1.0


def _jax_k2(x, taps, jdt):
    """conv4..6 of ``x [t3, C]`` as hriemo's ``_k2_kernel`` composes them
    (``_conv_k3s2`` over R3 + 2 rows, ``_conv_k2s2`` over the first R3 / 2
    of those, ``_conv_k2s2``), with R3 the rows rounded up to a multiple of
    8 and zeros past t3: each conv's valid rows, fp32."""
    t3 = x.shape[0]
    r3 = 8 * -(-t3 // 8)
    xj = jnp.asarray(np.pad(x, ((0, r3 + 2 - t3), (0, 0)))).astype(jdt)
    w4 = [jnp.asarray(taps[0][j].T).astype(jdt) for j in range(3)]
    w5, w6 = (jnp.asarray(np.concatenate([w[0].T, w[1].T])).astype(jdt) for w in taps[1:])
    y4 = _conv_k3s2(xj, *w4, True)
    y5 = _conv_k2s2(y4[:r3 // 2], w5, True)
    y6 = _conv_k2s2(y5, w6, True)
    lens, t = [], t3
    for k in CS.KERNEL[4:]:
        t = (t - k) // 2 + 1
        lens.append(t)
    return [np.array(y.astype(jnp.float32))[None, :n] for y, n in zip((y4, y5, y6), lens)]


@pytest.mark.parametrize("product", ["fp32", "3xtf32", "bf16"])
@pytest.mark.parametrize("t3", [259, 517, 1033, 255, 1017, 258])
def test_k2_as_strided_row_gemms_matches_jax(t3, product):
    """K2 as the card runs it: conv4, conv5 and conv6 each one GEMM over
    conv_rows of its input (tap-major weights read as [C_out, k*C_in]), with
    fp32 products or the card's 3xTF32 split (matmul_3xtf32), and the port's
    plain _conv_s2 (tap by tap), each conv against the JAX _k2_kernel's
    chain of _conv_k3s2 / _conv_k2s2 on the same input (the JAX chain's
    previous output); in fp32 also the whole chain, conv_stack_k2, against
    the JAX chain. t3 = 259, 517 and 1033 put t4, t5 and t6 at 129: one row
    past a 128-row GEMM tile; 255 and 1017 put t4 and t6 at 127, one short
    of it, and 258 (an even conv4 input) t4 at 128. fp32 at 1e-5; bf16
    within one step a conv."""
    rng = np.random.default_rng(t3)
    c = 64
    x = rng.standard_normal((t3, c)).astype(np.float32)
    taps = [(rng.standard_normal((k, c, c)) * np.sqrt(2.0 / (k * c))).astype(np.float32)
            for k in CS.KERNEL[4:]]
    dtype = torch.bfloat16 if product == "bf16" else torch.float32
    mm = matmul_3xtf32 if product == "3xtf32" else (lambda a, b: a @ b)
    xt = torch.from_numpy(x)[None].to(dtype)
    tt = [torch.from_numpy(w).to(dtype) for w in taps]
    refs = _jax_k2(x, taps, jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
    edge = {259: 129, 517: 129, 1033: 129, 255: 127, 1017: 127, 258: 128}[t3]
    assert edge in [r.shape[1] for r in refs]     # at a GEMM tile's edge

    def check(got, ref):
        assert got.dtype == dtype and got.shape == ref.shape
        if dtype == torch.float32:
            np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)
        else:
            assert _bf16_steps(got, ref).max() <= 1.0

    inp = xt
    for w, ref in zip(tt, refs):
        rows = CS.conv_rows(inp, w.shape[0])
        wk = w.permute(1, 0, 2).reshape(c, -1)      # [C_out, k*C_in], as the GEMM reads it
        check(gelu_fp32(mm(rows.float(), wk.float().t()), True).to(dtype), ref)
        check(CS._conv_s2(inp, w, True), ref)
        if dtype == torch.bfloat16:                 # the TMA GEMM's taps of the same rows
            parts = _tma_tap_rows(inp, w.shape[0])
            check(gelu_fp32(sum(p.float() @ w[j].float().t() for j, p in enumerate(parts)),
                            True).to(dtype), ref)
        inp = torch.from_numpy(ref).to(dtype)       # exact: the JAX output was stored in dtype
    if dtype == torch.float32:
        check(CS.conv_stack_k2(xt, *tt, True), refs[-1])


def _stats_in_chunks(wave, w0):
    """The card's order of the GroupNorm sums: fp32 sum and sum of squares
    of conv0 over each chunk of STATS_ROWS rows, then the chunks' partial
    sums added in chunk order. Returns them and the number of chunks."""
    x0 = CS._conv0(wave, w0)
    total, chunks = None, 0
    for r in range(0, x0.shape[1], CS.STATS_ROWS):
        c = x0[:, r:r + CS.STATS_ROWS]
        part = torch.stack([c.sum(dim=1), (c * c).sum(dim=1)], dim=1)
        total = part if total is None else total + part
        chunks += 1
    return total, chunks


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n0", [100, 2 * CS.STATS_ROWS, 2 * CS.STATS_ROWS + 1])
def test_stats_in_chunk_order(encoders, n0, dtype):
    """The stats as the card adds them (fp32 partial sums per chunk of
    STATS_ROWS conv0 rows, added in chunk order) at n0 below one chunk, at an
    exact multiple of it and one row past: against conv_stack_stats_plain
    and a float64 reference (rtol 1e-5: fp32 sums of a few hundred rows),
    and, in fp32, K1's and K2's plain versions on those sums against the JAX
    conv_stack_fused in interpret mode at 1e-5."""
    jm, tm = encoders
    tw = 5 * (n0 - 1) + 10
    wave = torch.from_numpy(_wave(n0, 2, tw)).to(dtype)
    w0, gn_w, gn_b, *taps = CS.stack_operands(tm.feature_extractor, dtype)
    stats, chunks = _stats_in_chunks(wave, w0)
    assert CS.conv_lengths(tw)[0] == n0 and chunks == -(-n0 // CS.STATS_ROWS)
    x64 = wave.double().unfold(1, 10, 5) @ w0.double().t()
    ref64 = torch.stack([x64.sum(dim=1), (x64 * x64).sum(dim=1)], dim=1)
    scale = (x64 * x64).sum(dim=1).max().item()   # the sums' magnitude
    for ref in (CS.conv_stack_stats_plain(wave, w0).double(), ref64):
        np.testing.assert_allclose(stats.double().numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-6 * scale)
    if dtype == torch.bfloat16:
        return
    eps = CFG.layer_norm_eps
    x3 = CS.conv_stack_k1_plain(wave, stats, w0, gn_w, gn_b, *taps[:3], eps, True)
    got = CS.conv_stack_k2_plain(x3, *taps[3:], True)
    ref = jax_conv_stack(jm.params["feature_extractor"], jnp.asarray(wave.numpy()), CFG)
    assert got.shape == ref.shape == (2, CS.conv_lengths(tw)[6], 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("b,m,n,want", [
    (384, 1999, 512, (256, 132)),   # conv1 at 1.25 s x 384: 12,288 wide tiles, 93.1 waves
    (32, 499, 512, (256, 132)),     # conv6 at 10 s x 32: 256 wide tiles, 2 waves (4 narrow)
    (4, 187, 512, (128, 32)),       # conv6 at 3.75 s x 4: 16 wide tiles, 32 narrow, one wave
    (1, 49, 512, (128, 4)),         # conv6 at 1 s x 1: the parent's 4 blocks
    (1, 3992, 3072, (256, 132)),    # the float FFN's first product at M = 3992
    (1, 3992, 768, (256, 96)),      # its second: 96 wide tiles, 192 narrow (2 waves)
])
def test_tma_gemm_plan(b, m, n, want):
    """The persistent TMA GEMM's plan (_cuda.tma_gemm_plan): one block an
    SM and at most one a tile; the 128-column tile where it cuts the waves
    by more than its cost (TMA_NARROW_COST), else the 256-column one; a
    forced tile kept, an unknown one refused."""
    from hriemo_torch.ops import _cuda

    assert _cuda.tma_gemm_plan(b, m, n, 132) == want
    rows = b * -(-m // _cuda.TMA_BM)
    for bn in _cuda.TMA_BN:
        assert _cuda.tma_gemm_plan(b, m, n, 132, bn=bn) == (bn, min(132, rows * -(-n // bn)))
    waves = {bn: -(-rows * -(-n // bn) // 132) for bn in _cuda.TMA_BN}
    cost = {256: 2 * waves[256], 128: _cuda.TMA_NARROW_COST * waves[128]}
    assert cost[want[0]] == min(cost.values())
    with pytest.raises(ValueError):
        _cuda.tma_gemm_plan(b, m, n, 132, bn=64)


@pytest.mark.parametrize("bn", [128, 256])
def test_tile_faults(bn):
    """chip_conv_routes.py --stress's count of faulty output tiles (128 rows
    by the column tile): a NaN marks a tile never stored, a finite value
    outside CONV_TOL a wrong one; a partial last row tile counts; values
    within the tolerance count for nothing."""
    from chip_conv_routes import tile_faults

    ref = torch.randn(2, 300, 512, generator=torch.Generator().manual_seed(0)).bfloat16()
    got = ref.clone()
    got[0, 5, 7] += 0.01                        # within CONV_TOL
    assert tile_faults(got, ref, bn) == (0, 0)
    got[1, 299, 511] = float("nan")             # the last, partial row tile
    got[1, 130:140, 0:3] = float("nan")         # one more tile
    got[0, 0, 300] = 1e8                        # wrong in column tile 300 // bn
    assert tile_faults(got, ref, bn) == (2, 1)
    got[0, 0, 400] = -1e8                       # another column tile only at bn 128
    assert tile_faults(got, ref, bn) == (2, 2 if bn == 128 else 1)
