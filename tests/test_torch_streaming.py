"""PyTorch port: the serving slice end to end (hriemo_torch/infer/streaming.py)
against the JAX StreamingPipeline on its kernel path (CPU, tiny width)."""

import numpy as np
import pytest
import torch

from hriemo.frontends import BertConfig, BertEncoder, WavLMConfig, WavLMEncoder
from hriemo.infer.streaming import StreamingPipeline as JaxPipeline
from hriemo.models import FusionWithEmotionDecoder
import hriemo_torch.frontends as TF
import hriemo_torch.models as TM
from hriemo_torch.frontends.wavlm import feat_extract_output_lengths
from hriemo_torch.infer import HashTokenizer, StreamingPipeline
from hriemo_torch.ops import attention_block as TA
from hriemo_torch.ops import flash_attention as TFA
from hriemo_torch.ops import fused_ffn as TFF
from hriemo_torch.ops import wavlm_attention as TW

from torch_port_helpers import (FP32_TOL, assert_kernel_close, one_torch_thread,  # noqa: F401
                                port, same_config)

D = 256
FUSION = dict(d_model=D, num_emotions=4, n_heads=8, num_layers_fusion=1,
              num_layers_decoder=1, beta_hidden=128)
SERVE = dict(max_seconds=0.15, max_tokens=32, multi_label=False, bucket_seconds=(0.1,),
             int8_frontends=True, wav_transport="pcm16", text_bucket_tokens=(8, 16))


@pytest.fixture(scope="module")
def models():
    wc = WavLMConfig.tiny(hidden_size=D, num_attention_heads=4, intermediate_size=512,
                          num_hidden_layers=1, fast_gelu=True)
    bc = BertConfig.tiny(hidden_size=D, num_attention_heads=4, intermediate_size=512,
                         num_hidden_layers=1, fast_gelu=True)
    jax_models = (WavLMEncoder(wc), BertEncoder(bc), FusionWithEmotionDecoder(**FUSION))
    torch_models = (port(jax_models[0], TF.WavLMEncoder(same_config(TF.WavLMConfig, wc))),
                    port(jax_models[1], TF.BertEncoder(same_config(TF.BertConfig, bc))),
                    port(jax_models[2], TM.FusionWithEmotionDecoder(**FUSION)))
    return jax_models, torch_models


def _requests(seed, n):
    rng = np.random.default_rng(seed)
    words = "happy sad angry neutral really very today fine so not".split()
    return [((rng.standard_normal(int(rng.integers(900, 2400))) * 3000).astype(np.int16),
             " ".join(rng.choice(words, int(rng.integers(1, 12)))), f"u{i}")
            for i in range(n)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_slice_matches_jax_kernel_path(models, monkeypatch, dtype):
    """W8A8 end to end at d=256: both audio buckets (0.1 s, 0.15 s), both
    text buckets, pcm16 transport; probabilities and beta. At fp32 compute
    the int8 sublayers take and store fp32 activations, as the JAX
    wrappers store x's dtype."""
    import jax.numpy as jnp

    monkeypatch.setenv("HRIEMO_FORCE_MEGAKERNELS", "1")
    (jw, jb, jf), (tw, tb, tf) = models
    tok = HashTokenizer(99)
    jp = JaxPipeline(jw, jb, jf, tokenizer=tok, compute_dtype=getattr(jnp, dtype), **SERVE)
    tp = StreamingPipeline(tw, tb, tf, tokenizer=tok, device="cpu",
                           compute_dtype=getattr(torch, dtype), **SERVE)
    clips = _requests(0, 6)
    for batch in (clips[:3], clips[3:]):
        wavs, texts = [c[0] for c in batch], [c[1] for c in batch]
        p_ref, b_ref = jp.infer(wavs, texts)
        p_got, b_got = tp.infer(wavs, texts)
        assert p_got.shape == (3, 4) and np.isfinite(p_got).all()
        np.testing.assert_allclose(p_got.sum(-1), 1.0, atol=1e-5)
        assert_kernel_close(p_got, p_ref)
        assert_kernel_close(b_got, b_ref)
    # every kernel route was taken (CPU tensors: the plain versions)
    assert tp.wavlm.encoder.layers[0].attn_ops is not None
    assert tp.bert.encoder.layer[0].mha_ops is not None
    assert tp.fusion.cross_modal.layers[0].ffn_a.ops is not None
    assert TA.attention_block_int8.launches == TFF.ffn_block_int8.launches == 0


SERVE_BF16 = dict(max_seconds=2.6, max_tokens=32, multi_label=False,
                  bucket_seconds=(0.1, 0.3, 1.3), int8_frontends=False,
                  wav_transport="pcm16", text_bucket_tokens=(8, 16))
# (clip samples low, high, WavLM frames of the bucket) per route class at the
# tiny strides (20 samples a frame): per-op; fused WavLM core; plus the
# one-pass fusion self-attention; per-op WavLM plus the streaming one
ROUTE_FLUSHES = [(900, 1600, 79), (3000, 4800, 239), (15000, 20800, 1039),
                 (30000, 41600, 2079)]


def _force_jax_kernel_routes(monkeypatch):
    """The JAX package's kernel gates without their TPU test, so its
    Pallas kernels run here in interpret mode."""
    import hriemo.nn.attention as jattn
    import hriemo.ops.flash_attention as jflash
    import hriemo.ops.wavlm_attention as jwavlm
    monkeypatch.setattr(jwavlm, "use_fused", TW.use_fused)
    monkeypatch.setattr(jattn, "_kernel_available", lambda: True)
    monkeypatch.setattr(jflash, "_use_pallas", TFA.use_flash)


def _spy(monkeypatch, module, names, calls):
    for name in names:
        fn = getattr(module, name)
        monkeypatch.setattr(module, name,
                            lambda *a, _f=fn, _n=name: calls.append(_n) or _f(*a))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_float_slice_matches_jax_kernel_path(models, monkeypatch, dtype):
    """The float tree (bf16, the served default, and fp32) at d=256, one
    flush of two clips in each route class of the attention cores;
    probabilities and beta against the JAX package on its kernel routes,
    and the port's route per flush."""
    import jax.numpy as jnp

    import hriemo.ops.flash_attention_pallas as jfp
    import hriemo.ops.wavlm_attention as jwavlm
    _force_jax_kernel_routes(monkeypatch)
    (jw, jb, jf), (tw, tb, tf) = models
    tok = HashTokenizer(99)
    jp = JaxPipeline(jw, jb, jf, tokenizer=tok, compute_dtype=getattr(jnp, dtype), **SERVE_BF16)
    tp = StreamingPipeline(tw, tb, tf, tokenizer=tok, device="cpu",
                           compute_dtype=getattr(torch, dtype), **SERVE_BF16)
    jax_calls, port_calls = [], []
    _spy(monkeypatch, jwavlm, ["_fused_impl"], jax_calls)
    _spy(monkeypatch, jfp, ["_onepass_impl", "_pallas_mha_fwd_impl"], jax_calls)
    _spy(monkeypatch, TW, ["wavlm_fused_attention_plain"], port_calls)
    _spy(monkeypatch, TFA, ["onepass_attention_plain", "streaming_attention_plain"], port_calls)
    jax_name = {"wavlm_fused_attention_plain": "_fused_impl",
                "onepass_attention_plain": "_onepass_impl",
                "streaming_attention_plain": "_pallas_mha_fwd_impl"}
    rng = np.random.default_rng(5)
    words = "happy sad angry neutral really very today fine so not".split()
    for lo, hi, frames in ROUTE_FLUSHES:
        wavs = [(rng.standard_normal(int(n)) * 3000).astype(np.int16)
                for n in (hi, rng.integers(lo, hi))]
        texts = [" ".join(rng.choice(words, int(rng.integers(1, 12)))) for _ in wavs]
        assert feat_extract_output_lengths(
            tw.config, tp.preprocess(wavs, texts)[0].shape[1]) == frames
        jax_calls.clear()
        port_calls.clear()
        p_ref, b_ref = jp.infer(wavs, texts)
        p_got, b_got = tp.infer(wavs, texts)
        want = (["wavlm_fused_attention_plain"] if 128 <= frames <= 2048 else []) + \
            (["onepass_attention_plain"] if 1024 <= frames <= 2048 else []) + \
            (["streaming_attention_plain"] if frames > 2048 else [])
        assert port_calls == want, (frames, port_calls)
        assert set(jax_calls) == {jax_name[c] for c in want}, (frames, jax_calls)
        assert p_got.shape == (2, 4) and np.isfinite(p_got).all()
        assert_kernel_close(p_got, p_ref)
        assert_kernel_close(b_got, b_ref)
        if dtype == "float32":  # no bf16 rounding: the fp32 tolerance holds
            np.testing.assert_allclose(p_got, p_ref, atol=FP32_TOL)
            np.testing.assert_allclose(b_got, b_ref, atol=FP32_TOL)


def test_stream_and_bucketed_scheduler(models):
    """stream() keeps batch order one flush behind; stream_bucketed() groups
    clips per audio bucket and returns every uid once, with the same
    result as a direct infer() of its flush."""
    _, (tw, tb, tf) = models
    tp = StreamingPipeline(tw, tb, tf, tokenizer=HashTokenizer(99), device="cpu", **SERVE)
    clips = _requests(1, 7)
    out = list(tp.stream([([c[0] for c in clips[i:i + 2]], [c[1] for c in clips[i:i + 2]],
                           [c[2] for c in clips[i:i + 2]]) for i in (0, 2, 4)]))
    assert [o[2] for o in out] == [["u0", "u1"], ["u2", "u3"], ["u4", "u5"]]
    flushes = list(tp.stream_bucketed(clips, default_batch=2, pad_flush=True))
    uids = [u for f in flushes for u in f[2]]
    assert sorted(uids) == sorted(c[2] for c in clips)
    for probs, beta, fu in flushes:
        assert probs.shape == (len(fu), 4) and beta.shape == (len(fu), 1)
        secs = {tp._bucket_for([clips[int(u[1:])][0]], 16000) for u in fu}
        assert len(secs) == 1  # one audio bucket per flush
    probs, beta, fu = flushes[0]
    batch = [clips[int(u[1:])] for u in fu]
    ref, _ = tp.infer([c[0] for c in batch], [c[1] for c in batch])
    np.testing.assert_allclose(probs, ref, atol=1e-6)


def test_entry_point_needs_a_card_unless_cpu_is_asked(models):
    _, (tw, tb, tf) = models
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")  # pragma: no cover
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingPipeline(tw, tb, tf, tokenizer=HashTokenizer(99))


def _recording(tp):
    """Wrap ``tp``'s forward, output copy and host read so that each call is
    logged as ("dispatch" | "copy" | "read", flush number)."""
    log, count = [], [0]
    forward, copy_out, host = tp._forward, tp._copy_out, tp._host

    def rec_forward(*args):
        log.append(("dispatch", count[0]))
        count[0] += 1
        return forward(*args)

    def rec_copy(outs):
        k = count[0] - 1
        log.append(("copy", k))
        return copy_out(outs), k

    def rec_host(handle):
        inner, k = handle
        log.append(("read", k))
        return host(inner)

    tp._forward, tp._copy_out, tp._host = rec_forward, rec_copy, rec_host
    return log


def _check_one_behind(log, flushes):
    """Flush n's outputs are copied out before flush n + 1 is dispatched and
    read after it, one flush behind; the last is read at the end."""
    at = {ev: i for i, ev in enumerate(log)}
    assert len(at) == len(log) == 3 * flushes
    for n in range(flushes):
        assert at["dispatch", n] < at["copy", n] < at["read", n]
        if n + 1 < flushes:
            assert at["copy", n] < at["dispatch", n + 1] < at["read", n]
        if n + 2 < flushes:
            assert at["read", n] < at["dispatch", n + 2]
    assert log[-1] == ("read", flushes - 1)


@pytest.mark.parametrize("which", ["stream", "stream_bucketed"])
def test_flush_copied_out_before_the_next_and_read_after_it(models, which):
    """The host feed's order: each flush's outputs are enqueued for the
    copy to the host right behind its forward, before the next flush is
    dispatched, and read one flush later; the outputs, their order and
    their uids are those of the same pipeline unwrapped, bit for bit."""
    _, (tw, tb, tf) = models
    make = lambda: StreamingPipeline(tw, tb, tf, tokenizer=HashTokenizer(99),  # noqa: E731
                                     device="cpu", **SERVE)
    clips = _requests(2, 7)
    if which == "stream":
        batches = [([c[0] for c in clips[i:i + 2]], [c[1] for c in clips[i:i + 2]],
                    [c[2] for c in clips[i:i + 2]]) for i in (0, 2, 4, 6)]
        run = lambda tp: list(tp.stream(batches))  # noqa: E731
    else:
        run = lambda tp: list(tp.stream_bucketed(clips, default_batch=2,  # noqa: E731
                                                 pad_flush=True))
    want = run(make())
    tp = make()
    log = _recording(tp)
    got = run(tp)
    _check_one_behind(log, len(want))
    assert len(got) == len(want) >= 3
    for (p, b, u), (pw, bw, uw) in zip(got, want):
        assert list(u) == list(uw)
        np.testing.assert_array_equal(p, pw)
        np.testing.assert_array_equal(b, bw)
