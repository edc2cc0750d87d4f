"""PyTorch port: the serving bench (hriemo_torch/bench.py), its analytic FLOP
count (hriemo_torch/utils/flops.py) and the pipeline's CUDA-graph switch,
against root ``bench.py`` on the CPU at tiny sizes."""

import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import bench as jax_bench
import hriemo_torch.bench as TB
from hriemo_torch.frontends import BertConfig, BertEncoder, WavLMConfig, WavLMEncoder
from hriemo_torch.infer import HashTokenizer, StreamingPipeline
from hriemo_torch.models import FusionWithEmotionDecoder
from hriemo_torch.ops.conv_stack import group_norm_stats_from_waveform
from hriemo_torch.tools import bucket_flops
from hriemo_torch.utils.flops import served_products

from torch_port_helpers import one_torch_thread, same_config  # noqa: F401

TINY_FUSION = dict(d_model=32, num_emotions=4, n_heads=4, num_layers_fusion=1,
                   num_layers_decoder=1, beta_hidden=16)
TINY_BUCKETS = (0.05, 0.1)
TINY_BATCH = {0.05: 4, 0.1: 4}


@pytest.fixture(scope="module")
def tiny_models():
    gen = torch.Generator().manual_seed(0)
    wavlm = WavLMEncoder(WavLMConfig.tiny(fast_gelu=True))
    bert = BertEncoder(BertConfig.tiny(vocab_size=30522, fast_gelu=True))
    fusion = FusionWithEmotionDecoder(**TINY_FUSION)
    for m in (wavlm, bert, fusion):
        m.init_weights(gen)
        m.eval().requires_grad_(False)
    return wavlm, bert, fusion


def test_constants_equal_the_jax_bench():
    assert TB.BUCKETS_S == jax_bench.BUCKETS_S
    assert TB.TEXT_BUCKETS == jax_bench.TEXT_BUCKETS
    assert TB.TOKENS_PER_SEC == jax_bench.TOKENS_PER_SEC
    assert TB.BUCKET_LT == jax_bench.BUCKET_LT
    assert TB.INT8_PROB_DELTA_MAX == jax_bench.INT8_PROB_DELTA_MAX
    assert TB.LT == jax_bench.LT and TB.B == jax_bench.B
    assert (TB.ITERS, TB.SPREAD_TOL) == (jax_bench.ITERS, jax_bench.SPREAD_TOL)


@pytest.mark.parametrize("n,seed", [(4096, 0), (3072, 7), (17, 3)])
def test_duration_mix_bit_equal(n, seed):
    np.testing.assert_array_equal(TB._duration_mix(n, seed), jax_bench._duration_mix(n, seed))


def test_scheduler_clip_stream_equals_jax(monkeypatch):
    """The seed-7 stream of 3072 clips, as root bench_scheduler builds it:
    its StreamingPipeline is stubbed to record what stream_bucketed is given."""
    import hriemo.infer.streaming as jax_streaming

    class Stop(Exception):
        pass

    seen = {}

    class Recorder:
        def __init__(self, *a, **k):
            self.preprocess = None

        def stream_bucketed(self, clips, bucket_batch=None, pad_flush=False):
            if pad_flush:
                seen["clips"] = list(clips)
                raise Stop
            return iter(())

    monkeypatch.setattr(jax_streaming, "StreamingPipeline", Recorder)
    with pytest.raises(Stop):
        jax_bench.bench_scheduler(None, None, None, {}, np.random.default_rng(0))
    got = TB.scheduler_clips()
    assert len(got) == len(seen["clips"]) == 3072
    for (w, t, u), (wj, tj, uj) in zip(got, seen["clips"]):
        assert u == uj and t == tj and w.dtype == wj.dtype == np.int16
        np.testing.assert_array_equal(w, wj)


def test_serving_configs_equal_jax(monkeypatch):
    """root build_serving_models's configurations, its classes stubbed to
    record their arguments (no full-width weights are drawn)."""
    import hriemo.frontends as jf
    import hriemo.models as jm
    import hriemo.ops.quant as jq

    made = {}

    def recorder(name):
        class Rec:
            params = {}

            def __init__(self, *a, **k):
                made[name] = (a, k)
        return Rec

    for mod, name in ((jf, "WavLMEncoder"), (jf, "BertEncoder"),
                      (jm, "FusionWithEmotionDecoder")):
        monkeypatch.setattr(mod, name, recorder(name))
    monkeypatch.setattr(jq, "quantize_tree_for_serving", lambda t: t)
    jax_bench.build_serving_models()
    wcfg, bcfg, fusion = TB.serving_configs()
    assert same_config(WavLMConfig, made["WavLMEncoder"][0][0]) == wcfg
    assert same_config(BertConfig, made["BertEncoder"][0][0]) == bcfg
    jax_fusion = dict(made["FusionWithEmotionDecoder"][1])
    assert jax_fusion.pop("dropout") == 0.1  # training only; the port's default too
    assert jax_fusion == fusion


@pytest.mark.parametrize("samples", [1600, 4800, 20800])
def test_flop_count_equals_flop_counter(tiny_models, samples):
    """The analytic count of the fp32 float forward against
    FlopCounterMode's count of the port's plain forward at WavLM 79, 239 and
    1039 frames (per-op core, the fused core's plain version, the fusion
    self-attention's flash route), less the Gram GroupNorm statistics,
    which the count leaves out on purpose."""
    wavlm, bert, fusion = tiny_models
    b, lt = 2, 16
    rng = np.random.default_rng(0)
    wav = torch.from_numpy(rng.standard_normal((b, samples)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 30000, size=(b, lt)))
    ones = lambda n: torch.ones((b, n), dtype=torch.int32)  # noqa: E731
    with torch.no_grad():
        with FlopCounterMode(display=False) as fc:
            h_a, fmask = wavlm(wav, ones(samples))
            h_t, _ = bert(ids, ones(lt))
            fusion(h_a, h_t, fmask == 0, ones(lt) == 0)
        with FlopCounterMode(display=False) as gram:
            group_norm_stats_from_waveform(wav, wavlm.feature_extractor.conv_layers[0].conv.weight)
    ops = served_products(wavlm.config, bert.config, TINY_FUSION, b, samples, lt, int8=False,
                          compute="fp32")
    assert gram.get_total_flops() > 0
    assert ops.total == fc.get_total_flops() - gram.get_total_flops()
    assert ops.by_dtype() == {"int8": 0.0, "bf16": 0.0, "fp32": ops.total}


def test_flop_count_routes_the_served_tree():
    """At full width the W8A8 tree files each product under its route's
    dtype: projections and FFNs int8, the int8 kernels' cores bf16, the
    decoder's per-op cores and the WavLM gate fp32, convolutions bf16."""
    wcfg, bcfg, fusion = TB.serving_configs()
    p = served_products(wcfg, bcfg, fusion, 128, 160_000, 64).items
    for name in ("wavlm.attn.proj", "wavlm.ffn", "wavlm.feature_projection", "bert.attn.proj",
                 "fusion.self_a.proj", "fusion.ffn_a", "beta.mlp2", "decoder.cross.proj"):
        assert p[name][1] == "int8", name
    for name in ("wavlm.conv0", "wavlm.pos_conv", "wavlm.attn.core", "bert.attn.core",
                 "fusion.a2t.core"):
        assert p[name][1] == "bf16", name
    for name in ("wavlm.attn.gate", "decoder.self.core", "decoder.cross.core"):
        assert p[name][1] == "fp32", name
    assert p["decoder.out_proj"][1] == "bf16"  # 768 -> 1 stays float
    # 499 frames at 10 s; the positional conv's even kernel gives one frame more
    assert p["wavlm.pos_conv"][0] == 2.0 * 128 * 500 * 48 * 128 * 768
    # the bf16 tree: the 2.5 s bucket's 124 frames run WavLM's core per op
    p16 = served_products(wcfg, bcfg, fusion, 8, 40_000, 12, int8=False).items
    assert p16["wavlm.attn.proj"][1] == "bf16" and p16["wavlm.attn.core"][1] == "fp32"


def test_bucket_flops_tool_prints_every_bucket(capsys, monkeypatch):
    monkeypatch.setattr(bucket_flops, "MEASURED_BUCKET_BATCH", {s: 64 for s in TB.BUCKETS_S})
    rows = bucket_flops.main([])
    assert [r["seconds"] for r in rows] == list(TB.BUCKETS_S)
    assert all(r["ops"]["int8"] > r["ops"]["fp32"] > 0 for r in rows)
    assert len(capsys.readouterr().out.strip().splitlines()) == len(TB.BUCKETS_S) + 1


def test_cuda_graphs_need_a_card(tiny_models):
    with pytest.raises(ValueError, match="cuda_graphs needs a CUDA device"):
        StreamingPipeline(*tiny_models, tokenizer=HashTokenizer(30522), device="cpu",
                          cuda_graphs=True)
    assert not StreamingPipeline(*tiny_models, tokenizer=HashTokenizer(30522),
                                 device="cpu").cuda_graphs


def _tiny_pipe(models):
    return TB.serving_pipeline(models, "cpu", buckets=TINY_BUCKETS, max_tokens=64)


def test_bucket_measurement_and_headline_on_cpu(tiny_models):
    pipe = _tiny_pipe(tiny_models)
    rng = np.random.default_rng(0)
    m = TB.measure(pipe, 4, 0.1, rng, lt=12, repeats=2, iters=1)
    assert m["batch"] == 4 and m["lt"] == 12 and m["mfu"] is None  # no device metric here
    assert m["ms_per_batch"] > 0 and m["ms_per_batch_best"] <= m["ms_per_batch"]
    assert m["spread"] >= 0 and m["ms_per_utt"] == m["ms_per_batch"] / 4
    assert m["ops"]["int8"] == 0 and m["bound_ms"] > 0  # tiny widths stay float
    mix = np.array([0.03, 0.04, 0.08, 0.1])
    h = TB.headline(pipe, rng, TINY_BUCKETS, TINY_BATCH, repeats=2, iters=1, mix=mix)
    want = 4 / sum(h["stats"][s]["ms_per_utt"] / 1e3 * 2 for s in TINY_BUCKETS)
    assert h["utt_per_sec"] == pytest.approx(want)


def test_scheduler_block_on_cpu(tiny_models):
    """Every field of the scheduler block on a stream of 24 short clips over
    two buckets (the counterpart of tests/test_bench_scheduler_smoke.py)."""
    pipe = _tiny_pipe(tiny_models)
    rng = np.random.default_rng(1)
    clips = [((rng.standard_normal(int(rng.uniform(0.02, 0.1) * 16000)) * 3000)
              .astype(np.int16), "happy sad", i) for i in range(24)]
    stats = {s: {"ms_per_batch": 1.0} for s in TINY_BUCKETS}
    out = TB.bench_scheduler(pipe, stats, bucket_batch=TINY_BATCH, clips=clips)
    for k in ("utt_per_sec_sustained", "n_clips", "flushes", "wall_ms", "graphs_captured_in_run",
              "flush_latency_ms_p50", "flush_latency_ms_p90", "flush_latency_ms_p99", "host_ms",
              "host_prep_ms", "host_h2d_enqueue_ms", "host_replay_enqueue_ms", "device_ms",
              "per_bucket", "h2d_mb", "h2d_gb_per_s_measured", "device_budget_ms",
              "utt_per_sec_device_resident", "device_resident_wall_ms",
              "device_resident_vs_budget", "note"):
        assert k in out, k
    assert out["n_clips"] == 24 and out["utt_per_sec_sustained"] > 0
    assert out["flushes"] == sum(b["flushes"] for b in out["per_bucket"].values()) >= 6
    assert out["device_ms"] is None and out["h2d_gb_per_s_measured"] is None  # the CPU
    assert out["device_budget_ms"] == out["flushes"] * 1.0
    assert 0 < out["flush_latency_ms_p50"] <= out["flush_latency_ms_p99"]
    assert out["host_ms"] >= out["host_prep_ms"] > 0
    assert out["utt_per_sec_device_resident"] > 0
    assert "preprocess" not in vars(pipe)  # the instrumentation is taken off


def test_fusion_only_block_on_cpu(tiny_models):
    pipe = _tiny_pipe(tiny_models)
    assert TB.fusion_only(pipe, np.random.default_rng(2), batch=2, la=40, lt=8) > 0


def test_train_block_on_cpu():
    out = TB.bench_train(torch.device("cpu"), n_steps=2, repeats=2, bt=2, acc=2, la=12, lt=8,
                         model_kw=dict(d_model=32), throughput_bt=4)
    assert out["ms_per_step"] > 0 and out["examples_per_sec"] > 0
    assert out["throughput"]["ms_per_step"] > 0 and "batch 4 x accum 1" in \
        out["throughput"]["config"]


def _full_artifact():
    """An artifact with every field the bench prints, at realistic scale."""
    bucket = dict(batch=384, lt=12, ms_per_batch=123.456789, ms_per_batch_best=122.1,
                  spread=0.0123456, ms_per_utt=0.3215, samples=5, iters=10,
                  ops={"int8": 1.2e13, "bf16": 8.1e12, "fp32": 1e9}, bound_ms=14.3,
                  mfu=0.11583456)
    return dict(metric="iemocap_e2e_utterances_per_sec_per_card_incl_frontends",
                value=2345.678912, unit="utterances/s/card",
                card="NVIDIA H100 80GB HBM3, 700.00 W", device="NVIDIA H100 80GB HBM3",
                cuda_graphs=True, blocks=["buckets", "int8_prob_delta", "train", "scheduler",
                                          "bf16_ms_per_batch64_5s", "p50_ms_per_clip",
                                          "fusion_only_utt_per_sec"],
                buckets={str(s): dict(bucket) for s in TB.BUCKETS_S},
                int8_prob_delta=0.00123456, p50_ms_per_clip=4.56789,
                bf16_ms_per_batch64_5s=33.3333, fusion_only_utt_per_sec=12345.678,
                train={"ms_per_step": 12.345678, "throughput": {"ms_per_step": 234.5678}},
                scheduler={"utt_per_sec_sustained": 1234.5678, "flush_latency_ms_p50": 45.678,
                           "flush_latency_ms_p99": 123.456, "host_ms": 2345.678,
                           "device_ms": 1234.567, "utt_per_sec_device_resident": 2000.1,
                           "note": "x" * 600},
                mfu_note=TB.MFU_NOTE, failed_block="scheduler")


def test_compact_line_fits_and_round_trips(capsys):
    TB.emit(_full_artifact())
    full, last = capsys.readouterr().out.strip().splitlines()
    assert json.loads(full)["buckets"]["5.0"]["ms_per_batch"] == 123.456789
    assert len(last) <= 1500
    s = json.loads(last)
    assert s["card"] == "NVIDIA H100 80GB HBM3, 700.00 W" and s["cuda_graphs"] is True
    assert set(s["buckets"]) == {str(x) for x in TB.BUCKETS_S}
    assert s["buckets"]["5.0"] == [384, 123.5, 122.1, 0.012, 0.116]
    for k in ("value", "int8_prob_delta", "p50_ms_per_clip", "train_ms_per_step",
              "train_ms_per_step_b512", "failed_block", "blocks"):
        assert k in s, k
    for k in ("utt_per_sec_sustained", "flush_latency_ms_p50", "flush_latency_ms_p99",
              "host_ms", "device_ms"):
        assert k in s["scheduler"], k


def test_a_failed_block_prints_then_raises(capsys):
    out = dict(metric="m", value=None, unit="u", blocks=["buckets"])

    def boom():
        raise RuntimeError("no")

    with pytest.raises(RuntimeError, match="no"):
        TB.run_block(out, "train", boom)
    s = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert s["failed_block"] == "train" and s["blocks"] == ["buckets"]
