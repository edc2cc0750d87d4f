#!/usr/bin/env python3
"""Serving throughput bench of the PyTorch port on one NVIDIA GPU (port of
root ``bench.py``'s semantics).

    python3 -m hriemo_torch.bench [--seed 0]

What it serves: waveform + tokens -> WavLM base-plus -> BERT-base ->
``FusionWithEmotionDecoder`` (d=768, 8 heads, 2+2 layers, beta hidden 256,
4 emotions) -> emotion probabilities, W8A8 int8 end to end through the
port's kernels, each (audio bucket, text bucket, batch) forward replayed as
one CUDA graph (``StreamingPipeline(cuda_graphs=True)``, the counterpart of
the JAX package's one compile per bucket). Weights are random from
``--seed``: throughput does not depend on them.

Blocks, in order; each prints the artifact so far as a JSON line followed
by a compact summary line (at most 1.5 KB, the last line of the output):

* the headline: each of the 14 audio buckets at its text bucket and its
  batch from ``MEASURED_BUCKET_BATCH``, ms per batch over graph replays
  between CUDA events (ten replays a sample, five samples; the median is
  the bucket's number, with best and spread beside it; a spread above 5%
  re-samples at ten samples of twenty), weighted by the IEMOCAP duration
  mix into utterances per second per card; per bucket ``mfu``, the share
  of the card's compute bound (:mod:`hriemo_torch.utils.flops`);
* ``int8_prob_delta``: max |int8 - bf16| probability at the 5 s bucket, B=64, kernels
  on both, gated at :data:`INT8_PROB_DELTA_MAX` (a failure exits non-zero);
* ``train``: the MOSEI v2 flagship configuration on the port's eager train
  step (batch 16 x accum 2, and a batch-512 throughput row);
* ``scheduler``: ``stream_bucketed`` as served (int16 PCM clips, the hash
  tokenizer, 3072 clips of the seed-7 duration stream, ``pad_flush``): host
  ms per flush beside device ms, flush latency, measured pinned H2D rate,
  and the same flush schedule re-run with every input already on the card;
* ``bf16_ms_per_batch64_5s``, ``p50_ms_per_clip`` (B=1 at the median
  bucket, int8) and ``fusion_only_utt_per_sec``.

A block that fails prints what is measured so far and the bench exits
non-zero. Without a card it raises unless ``device="cpu"`` is asked for,
which the tests do: that run is eager, times on the host clock and reports
no device metric.
"""

from __future__ import annotations

import argparse
import bisect
import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

from .infer.streaming import MEASURED_BUCKET_BATCH, HashTokenizer, StreamingPipeline
from .utils.flops import served_products

SR = 16_000
# audio buckets (s): the JAX bench's 14 (bench.py:126-127)
BUCKETS_S = (1.25, 1.875, 2.5, 3.125, 3.75, 4.375, 5.0, 5.625,
             6.25, 6.875, 7.5, 8.125, 8.75, 10.0)
# text buckets (tokens), output-exact; each audio bucket's at ~150 words
# per minute x ~1.3 wordpieces a word + [CLS]/[SEP] (bench.py:172-178)
TEXT_BUCKETS = (8, 12, 16, 20, 24, 32, 64)
TOKENS_PER_SEC = 3.25
BUCKET_LT = {sec: next(tb for tb in (*TEXT_BUCKETS, 128)
                       if 2 + math.ceil(TOKENS_PER_SEC * sec) <= tb)
             for sec in BUCKETS_S}
TEXT_MIX_NOTE = (
    "text length tied to audio duration at ~150 wpm conversational English x ~1.3 BERT "
    f"wordpieces/word (+2 specials); flushes ride the output-exact text buckets "
    f"{TEXT_BUCKETS} instead of the reference's fixed max_length=128 padding")
LT = 128    # the reference's text length (bf16 continuity number)
B = 64      # batch of the int8 gate and the bf16 continuity number
ITERS = 10  # graph replays a sample
REPEATS = 5
SPREAD_TOL = 0.05
# int8 numerics gate (bench.py:190-194): max |int8 - bf16| probability
INT8_PROB_DELTA_MAX = 0.006
# published IEMOCAP duration statistics (Busso et al. 2008): 12 h 26 min
# over 10,039 turns, mean 4.46 s, sd 3.06 s; a lognormal moment match
IEMOCAP_MEAN_S = 4.46
IEMOCAP_SD_S = 3.06
DURATION_MIX_NOTE = (
    "lognormal moment-matched to published IEMOCAP stats "
    f"(mean {IEMOCAP_MEAN_S} s = 12h26m/10039 turns, sd {IEMOCAP_SD_S} s; "
    "Busso et al. 2008), capped at 10 s (reference's WavLM cap)")
# the served fusion model (bench.py:733-736)
FUSION = dict(d_model=768, num_emotions=4, n_heads=8, num_layers_fusion=2,
              num_layers_decoder=2, beta_hidden=256)
MFU_NOTE = ("mfu = (int8 products / 1979e12 + bf16 products / 989e12 + fp32 products / "
            "67e12) / measured s: the share of the H100 SXM dense compute bound, <= 1 by "
            "construction; products counted from the shapes (hriemo_torch/utils/flops.py), "
            "elementwise work and the Gram GroupNorm statistics not counted")
COMPACT_MAX = 1500


def _duration_mix(n=4096, seed=0):
    """IEMOCAP clip durations (s) from the published-stat lognormal fit."""
    rng = np.random.default_rng(seed)
    cv2 = (IEMOCAP_SD_S / IEMOCAP_MEAN_S) ** 2
    sigma = np.sqrt(np.log1p(cv2))
    mu = np.log(IEMOCAP_MEAN_S) - 0.5 * sigma**2
    d = rng.lognormal(mean=mu, sigma=sigma, size=n)
    return np.clip(d, 0.6, 10.0)


def scheduler_clips(n_clips: int = 3072, seed: int = 7):
    """The scheduler block's clip stream (bench.py:435-451): int16 PCM
    clips of the duration mix, transcripts of ``round(3.25 d)`` words (at
    least 3), uid = index."""
    durations = _duration_mix(n=n_clips, seed=seed)
    words = np.array("happy sad angry neutral really very today fine so not".split())
    rs = np.random.default_rng(seed)
    return [((rs.standard_normal(int(d * SR)) * 0.1 * 32768)
             .clip(-32768, 32767).astype(np.int16),
             " ".join(rs.choice(words, size=_n_words(d))), i)
            for i, d in enumerate(durations)]


def _n_words(d: float) -> int:
    return max(3, int(round(TOKENS_PER_SEC * d)))


def serving_configs():
    """The served stack's configurations (bench.py:716-736): WavLM
    base-plus and BERT-base with tanh GELU, and :data:`FUSION`."""
    from .frontends import BertConfig, WavLMConfig

    return (dataclasses.replace(WavLMConfig.base_plus(), fast_gelu=True),
            dataclasses.replace(BertConfig.base_uncased(), fast_gelu=True), dict(FUSION))


def build_serving_models(seed: int = 0, configs=None):
    """The served stack's modules with random fp32 weights drawn from
    ``seed``; a pipeline casts and quantizes its own copy."""
    from .frontends import BertEncoder, WavLMEncoder
    from .models import FusionWithEmotionDecoder

    wcfg, bcfg, fusion_cfg = configs or serving_configs()
    gen = torch.Generator().manual_seed(seed)
    wavlm, bert = WavLMEncoder(wcfg), BertEncoder(bcfg)
    fusion = FusionWithEmotionDecoder(**fusion_cfg)
    for m in (wavlm, bert, fusion):
        m.init_weights(gen)
    return wavlm, bert, fusion


def serving_pipeline(models, device=None, int8: bool = True, buckets=BUCKETS_S,
                     max_tokens: int = LT, cuda_graphs: bool | None = None):
    """The served pipeline (bench.py:410-415): pcm16 transport, the hash
    tokenizer, softmax probabilities, the audio and text buckets."""
    return StreamingPipeline(*models, tokenizer=HashTokenizer(30522), max_seconds=max(buckets),
                             max_tokens=max_tokens, multi_label=False,
                             bucket_seconds=tuple(buckets), int8_frontends=int8,
                             wav_transport="pcm16", text_bucket_tokens=TEXT_BUCKETS,
                             device=device, cuda_graphs=cuda_graphs)


# ------------------------------------------------------------------ timing

def _progress(msg: str) -> None:
    print(f"# [{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def time_calls(fn, n: int, device: torch.device) -> float:
    """Seconds per call of ``fn`` over ``n`` calls: CUDA events on the card
    (device time of what the calls enqueue), the host clock on the CPU."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / n
    t = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t) / n


def sample_times(fn, device, repeats: int = REPEATS, iters: int = ITERS) -> dict:
    """``fn`` once to warm up (captures its graph), then ``repeats`` samples
    of ``iters`` calls; above :data:`SPREAD_TOL` spread, twice the samples
    of twice the calls (bench.py:833-837). Median, best, spread (max - min
    over best), the sample sizes."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    times = [time_calls(fn, iters, device) for _ in range(repeats)]
    if (max(times) - min(times)) / min(times) > SPREAD_TOL:
        repeats, iters = 2 * repeats, 2 * iters
        times = [time_calls(fn, iters, device) for _ in range(repeats)]
    return dict(median_s=float(np.median(times)), best_s=min(times),
                spread=(max(times) - min(times)) / min(times), samples=repeats, iters=iters)


def bucket_inputs(pipe, batch: int, seconds: float, lt: int, rng):
    """Device tensors of one full flush: int16 PCM clips filling the bucket
    and ``lt`` random token ids, every position valid."""
    t = int(seconds * SR)
    dev = pipe.device
    wavs = torch.from_numpy((rng.standard_normal((batch, t)) * 0.1 * 32768)
                            .clip(-32768, 32767).astype(np.int16)).to(dev)
    lengths = torch.full((batch,), t, dtype=torch.int32, device=dev)
    ids = torch.from_numpy(rng.integers(0, 30000, size=(batch, lt))).to(dev)
    tmask = torch.ones((batch, lt), dtype=torch.int32, device=dev)
    return wavs, lengths, ids, tmask


def measure(pipe, batch: int, seconds: float, rng, lt: int | None = None,
            repeats: int = REPEATS, iters: int = ITERS) -> dict:
    """ms per batch of ``pipe``'s forward at one bucket (its graph replayed
    on the card), with the analytic products and ``mfu``."""
    lt = BUCKET_LT.get(seconds, pipe.max_tokens) if lt is None else lt
    args = bucket_inputs(pipe, batch, seconds, lt, rng)
    st = sample_times(lambda: pipe._forward(*args), pipe.device, repeats, iters)
    w, b = pipe.wavlm.config, pipe.bert.config
    int8 = pipe.wavlm.encoder.layers[0].attention.q_proj.w_int8 is not None
    ops = served_products(w, b, fusion_config(pipe.fusion), batch, int(seconds * SR), lt,
                          int8=int8, compute="bf16" if pipe._dt == torch.bfloat16 else "fp32")
    on_card = pipe.device.type == "cuda"
    return dict(batch=batch, lt=lt, ms_per_batch=st["median_s"] * 1e3,
                ms_per_batch_best=st["best_s"] * 1e3, spread=st["spread"],
                ms_per_utt=st["median_s"] * 1e3 / batch, samples=st["samples"],
                iters=st["iters"], ops=ops.by_dtype(), bound_ms=ops.bound_s() * 1e3,
                mfu=ops.bound_s() / st["median_s"] if on_card else None)


def fusion_config(fusion) -> dict:
    """``FusionWithEmotionDecoder``'s arguments, read off a (served) module."""
    layer = fusion.cross_modal.layers[0]
    mlp0 = fusion.beta_gate.mlp._modules["0"]
    w0 = mlp0.weight if mlp0.weight is not None else mlp0.w_int8
    return dict(d_model=fusion.beta_gate.norm_a.weight.shape[0],
                num_emotions=fusion.emotion_decoder.emotion_queries.shape[0],
                n_heads=layer.self_attn_a.n_heads,
                num_layers_fusion=len(fusion.cross_modal.layers),
                num_layers_decoder=len(fusion.emotion_decoder.layers),
                beta_hidden=w0.shape[0])


def headline(pipe, rng, buckets=BUCKETS_S, bucket_batch=None, repeats=REPEATS,
             iters=ITERS, mix=None) -> dict:
    """Each bucket at its batch, and utterances per second over the
    duration mix (``mix``: durations, default :func:`_duration_mix`)."""
    bucket_batch = MEASURED_BUCKET_BATCH if bucket_batch is None else bucket_batch
    stats = {}
    for sec in buckets:
        stats[sec] = measure(pipe, bucket_batch[sec], sec, rng, repeats=repeats, iters=iters)
        _progress(f"bucket {sec} s B={bucket_batch[sec]}: "
                  f"{stats[sec]['ms_per_batch']:.3f} ms/batch")
    durations = _duration_mix() if mix is None else mix
    bucket_of = np.searchsorted(np.asarray(buckets), durations)
    total_s = sum(int((bucket_of == i).sum()) * stats[sec]["ms_per_utt"] / 1e3
                  for i, sec in enumerate(buckets))
    return dict(stats=stats, utt_per_sec=len(durations) / total_s)


# ------------------------------------------------------------------ blocks

def int8_prob_delta(pipe_int8, pipe_bf16, rng, batch: int = B, seconds: float = 5.0) -> float:
    """max |int8 - bf16| probability, same requests, kernels on both
    (bench.py:919-944)."""
    args = bucket_inputs(pipe_int8, batch, seconds, BUCKET_LT[seconds], rng)
    p8 = pipe_int8._forward(*args)[0].cpu().numpy()
    p16 = pipe_bf16._forward(*args)[0].cpu().numpy()
    return float(np.abs(p8 - p16).max())


def fusion_only(pipe, rng, batch: int = B, la: int = 499, lt: int = LT) -> float:
    """Utterances per second of the served fusion model alone on features
    (bench.py:1009-1032: B=64, 499 audio and 128 text frames, random
    padding), replayed as a CUDA graph on the card."""
    from .infer.streaming import capture_graph

    dev, dt = pipe.device, pipe._dt
    d = fusion_config(pipe.fusion)["d_model"]
    h_a = torch.from_numpy(rng.standard_normal((batch, la, d)).astype(np.float32)).to(dev, dt)
    h_t = torch.from_numpy(rng.standard_normal((batch, lt, d)).astype(np.float32)).to(dev, dt)
    mask_a = torch.from_numpy(np.arange(la)[None, :] >= rng.integers(la // 2, la + 1,
                                                                     size=batch)[:, None])
    mask_t = torch.from_numpy(np.arange(lt)[None, :] >= rng.integers(lt // 2, lt + 1,
                                                                     size=batch)[:, None])
    args = (h_a, h_t, mask_a.to(dev), mask_t.to(dev))

    def fwd(*a):
        return pipe.fusion(*a)[0]

    with torch.inference_mode():
        if dev.type == "cuda":
            graph, _ = capture_graph(fwd, [a.clone() for a in args], torch.cuda.graph_pool_handle())
            st = sample_times(graph.replay, dev, REPEATS, 30)
        else:
            st = sample_times(lambda: fwd(*args), dev, REPEATS, 3)
    return batch / st["median_s"]


def h2d_rate(nbytes: int, device) -> float | None:
    """Pinned host -> card copy rate (bytes/s) of one ``nbytes`` buffer,
    best of three; None on the CPU."""
    if device.type != "cuda":
        return None
    src = torch.empty(nbytes, dtype=torch.uint8).pin_memory()
    dst = torch.empty(nbytes, dtype=torch.uint8, device=device)
    dst.copy_(src, non_blocking=True)
    torch.cuda.synchronize(device)
    return nbytes / min(time_calls(lambda: dst.copy_(src, non_blocking=True), 1, device)
                        for _ in range(3))


def _pct(xs, q) -> float | None:
    return float(np.percentile(xs, q)) if len(xs) else None


def bench_scheduler(pipe, bucket_stats: dict, bucket_batch: dict | None = None,
                    clips=None) -> dict:
    """``stream_bucketed`` as served (bench.py:381-575), on ``pipe`` (the
    int8 tree, pcm16, the hash tokenizer) with ``pad_flush``, over
    :func:`scheduler_clips`; each bucket's shape is warmed first, so graph
    captures stay out of the timed run where the flushes keep the warm
    text bucket. Per flush: host ms (preprocess; pinning and the H2D
    enqueue; the replay enqueue) and device ms (CUDA events around the
    replay), and its latency from the start of its preprocess to its
    result in host memory. Then the same flush schedule with every input
    already on the card."""
    bucket_batch = MEASURED_BUCKET_BATCH if bucket_batch is None else bucket_batch
    clips = scheduler_clips() if clips is None else clips
    dev = pipe.device
    on_card = dev.type == "cuda"
    words = lambda sec: " ".join(["warm"] * _n_words(sec))  # noqa: E731
    for sec in pipe.bucket_seconds:
        b = bucket_batch[sec]
        warm = [(np.zeros(int(sec * SR) - 1, np.int16), words(sec), -1)] * b
        for _ in pipe.stream_bucketed(iter(warm), bucket_batch=bucket_batch):
            pass
    graphs_before = len(pipe._graphs)

    flushes = []  # one dict a flush, in dispatch order
    orig_prep, orig_dispatch, orig_replay = pipe.preprocess, pipe._dispatch, pipe._replay

    def prep(waveforms, texts, sample_rate=SR):
        t = time.perf_counter()
        out = orig_prep(waveforms, texts, sample_rate)
        flushes.append(dict(start=t, prep_s=time.perf_counter() - t, arrs=out,
                            sec=pipe._bucket_for(waveforms, sample_rate)))
        return out

    def dispatch(arrs, rows=None):
        t = time.perf_counter()
        out = orig_dispatch(arrs, rows)
        flushes[-1]["dispatch_s"] = time.perf_counter() - t
        return out

    def replay(graph, static_out):
        f = flushes[-1]
        t = time.perf_counter()
        if on_card:
            f["events"] = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            f["events"][0].record()
        out = orig_replay(graph, static_out)
        if on_card:
            f["events"][1].record()
        f["replay_s"] = time.perf_counter() - t
        return out

    pipe.preprocess, pipe._dispatch, pipe._replay = prep, dispatch, replay
    try:
        n_done, k = 0, 0
        t0 = time.perf_counter()
        for _probs, _beta, uids in pipe.stream_bucketed(iter(clips), bucket_batch=bucket_batch,
                                                        pad_flush=True):
            flushes[k]["done"] = time.perf_counter()
            n_done += len(uids)
            k += 1
        if on_card:
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    finally:
        del pipe.preprocess, pipe._dispatch, pipe._replay
    if n_done != len(clips):
        raise AssertionError(f"scheduler served {n_done} of {len(clips)} clips")

    for f in flushes:
        f["h2d_enqueue_s"] = f["dispatch_s"] - f.get("replay_s", 0.0)
        f["device_ms"] = f["events"][0].elapsed_time(f["events"][1]) if "events" in f else None
        f["host_ms"] = (f["prep_s"] + f["dispatch_s"]) * 1e3
    latency = [(f["done"] - f["start"]) * 1e3 for f in flushes]
    per_bucket = {}
    for sec in pipe.bucket_seconds:
        mine = [f for f in flushes if f["sec"] == sec]
        if not mine:
            continue
        host = float(np.mean([f["host_ms"] for f in mine]))
        device = float(np.mean([f["device_ms"] for f in mine])) if on_card else None
        per_bucket[str(sec)] = dict(
            flushes=len(mine), host_ms_per_flush=host, device_ms_per_flush=device,
            bound_by=None if device is None else ("host" if host > device else "device"))
    h2d_bytes = sum(sum(a.nbytes for a in f["arrs"]) for f in flushes)
    rate = h2d_rate(max(a.nbytes for a in flushes[0]["arrs"]), dev)
    device_budget_s = sum(bucket_stats[f["sec"]]["ms_per_batch"] / 1e3 for f in flushes
                          if f["sec"] in bucket_stats)

    # the recorded flush schedule again with every input on the card: the
    # same graphs through _forward, each result read one flush behind
    staged = [tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in f["arrs"])
              for f in flushes]
    for args in staged:
        pipe._forward(*args)[0].cpu()
    dev_walls = []
    for _ in range(3):
        pending = None
        t = time.perf_counter()
        for args in staged:
            probs = pipe._forward(*args)[0]
            if pending is not None:
                pending.cpu()
            pending = probs
        pending.cpu()
        dev_walls.append(time.perf_counter() - t)
    dev_wall = float(np.median(dev_walls))

    host_ms = sum(f["host_ms"] for f in flushes)
    device_ms = sum(f["device_ms"] for f in flushes) if on_card else None
    return dict(
        utt_per_sec_sustained=n_done / wall, n_clips=len(clips), flushes=len(flushes),
        wall_ms=wall * 1e3, graphs_captured_in_run=len(pipe._graphs) - graphs_before,
        flush_latency_ms_p50=_pct(latency, 50), flush_latency_ms_p90=_pct(latency, 90),
        flush_latency_ms_p99=_pct(latency, 99),
        host_ms=host_ms, host_prep_ms=sum(f["prep_s"] for f in flushes) * 1e3,
        host_h2d_enqueue_ms=sum(f["h2d_enqueue_s"] for f in flushes) * 1e3,
        host_replay_enqueue_ms=sum(f.get("replay_s", 0.0) for f in flushes) * 1e3,
        device_ms=device_ms, per_bucket=per_bucket,
        h2d_mb=h2d_bytes / 1e6, h2d_gb_per_s_measured=None if rate is None else rate / 1e9,
        device_budget_ms=device_budget_s * 1e3,
        utt_per_sec_device_resident=n_done / dev_wall, device_resident_wall_ms=dev_wall * 1e3,
        device_resident_vs_budget=(dev_wall / device_budget_s if device_budget_s else None),
        note=("stream_bucketed as served: int16 PCM clips, pcm16 transport, hash tokenizer, "
              "host preprocess overlapped with the device by the one-deep pending queue, "
              "pad_flush static shapes, each bucket's graph captured before the timed run. "
              "host_ms = preprocess + _dispatch (pinning, H2D enqueue, replay enqueue, D2H enqueue); "
              "device_ms = CUDA events around each replay and its output copy; flush "
              "latency = start of a flush's preprocess to its result in host memory "
              f"({len(flushes)} flushes: p99 is their largest ones); device_resident re-runs "
              "the recorded flushes through _forward with inputs on the card (median of 3), "
              "device_budget_ms sums the headline's ms/batch over the same flushes"))


def bench_train(device, n_steps: int = 20, repeats: int = 3, bt: int = 16, acc: int = 2,
                la: int = 300, lt: int = 128, model_kw: dict | None = None,
                throughput_bt: int | None = 512) -> dict:
    """The MOSEI v2 flagship configuration (bench.py:578-685: d_model 256,
    4 heads, 1 fusion + 2 decoder layers, beta hidden 64, dropout 0.4, lr
    5e-5, wd 0.05, batch 16 x accum 2, pos_weight BCE + beta entropy 1e-3,
    label normalisation; bf16 compute over fp32 masters; 300 audio and 128
    text frames) on the port's eager train step
    (``parallel/train_step.py::make_train_step``), with a throughput row at
    batch ``throughput_bt`` x accum 1. ms per step: the host clock over
    ``n_steps`` steps closed by a synchronize, median of ``repeats``."""
    from .models import MoseiFusionWithEmotionDecoder
    from .parallel.train_step import TrainConfig, create_train_state, make_train_step
    from .train.common import dropout_seed, step_generator

    kw = dict(d_audio=74, d_text=300, d_model=256, num_emotions=6, n_heads=4,
              num_layers_fusion=1, num_layers_decoder=2, beta_hidden=64, dropout=0.4)
    kw.update(model_kw or {})
    model = MoseiFusionWithEmotionDecoder(**kw)
    model.init_weights(torch.Generator().manual_seed(0))
    model.to(device)
    cfg = TrainConfig(loss_type="multi_label",
                      pos_weight=[0.87, 2.82, 3.63, 8.94, 4.53, 11.27][:kw["num_emotions"]],
                      beta_entropy=1e-3, normalize_labels=True, lr=5e-5, weight_decay=0.05,
                      grad_accum=acc, warmup_steps=100, total_steps=10_000,
                      compute_dtype=torch.bfloat16)
    state = create_train_state(model, cfg)
    step = make_train_step(model, cfg)
    rs = np.random.default_rng(3)
    lead = (acc, bt) if acc > 1 else (bt,)
    mask = lambda l: np.arange(l) >= rs.integers(l // 2, l + 1, size=lead)[..., None]  # noqa: E731
    batch = {"h_a": rs.standard_normal((*lead, la, kw["d_audio"])).astype(np.float32),
             "h_t": rs.standard_normal((*lead, lt, kw["d_text"])).astype(np.float32),
             "mask_a": mask(la), "mask_t": mask(lt),
             "y": rs.uniform(0, 3, size=(*lead, kw["num_emotions"])).astype(np.float32)}
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    base = dropout_seed(0)

    def run(n, offset):
        for i in range(n):
            _, metrics = step(state, batch, step_generator(base, offset + i, device))
        loss = float(metrics["loss"])  # the last step's loss closes the run
        if not math.isfinite(loss):
            raise AssertionError(f"train step: loss {loss}")

    run(2, 0)  # warm up: first calls, allocator
    walls = []
    for r in range(repeats):
        t = time.perf_counter()
        run(n_steps, 1000 * (r + 1))
        walls.append((time.perf_counter() - t) / n_steps)
    ms = float(np.median(walls)) * 1e3
    out = dict(config=(f"MOSEI v2 flagship: d_model={kw['d_model']} h{kw['n_heads']} "
                       f"{kw['num_layers_fusion']}xfusion+{kw['num_layers_decoder']}xdecoder, "
                       f"bf16 compute/fp32 params, batch {bt} x accum {acc}, La={la} Lt={lt}, "
                       "pos_weight BCE + beta-entropy, AdamW, dropout 0.4"),
               ms_per_step=ms, ms_per_step_best=min(walls) * 1e3,
               examples_per_sec=bt * acc / (ms / 1e3),
               tokens_per_sec=bt * acc * (la + lt) / (ms / 1e3),
               timing=(f"median of {repeats} runs of {n_steps} eager steps, host clock "
                       "closed by reading the last loss"))
    if throughput_bt:
        thr = bench_train(device, n_steps, repeats, throughput_bt, 1, la, lt, model_kw, None)
        out["throughput"] = {k: thr[k] for k in
                             ("config", "ms_per_step", "examples_per_sec", "tokens_per_sec")}
    return out


# ------------------------------------------------------------------ output

def card() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def _r(x, digits=4):
    """``x`` to ``digits`` significant digits, for the compact line only."""
    if x is None or not math.isfinite(x) or x == 0:
        return x
    return round(x, digits - 1 - int(math.floor(math.log10(abs(x)))))


def compact_summary(out: dict) -> dict:
    """The last line: the numbers a reader needs, at most 1.5 KB."""
    s = {k: out[k] for k in ("metric", "value", "unit", "card", "device", "cuda_graphs")
         if k in out}
    s["value"] = _r(s.get("value"), 6)
    if "buckets" in out:
        s["bucket_fields"] = "batch, ms_per_batch (median), best, spread, mfu"
        s["buckets"] = {sec: [b["batch"], _r(b["ms_per_batch"]), _r(b["ms_per_batch_best"]),
                              _r(b["spread"], 2), _r(b["mfu"], 3)]
                        for sec, b in out["buckets"].items()}
    for k in ("int8_prob_delta", "p50_ms_per_clip", "bf16_ms_per_batch64_5s",
              "fusion_only_utt_per_sec"):
        if out.get(k) is not None:
            s[k] = _r(out[k])
    sch = out.get("scheduler")
    if isinstance(sch, dict):
        s["scheduler"] = {k: _r(sch[k]) for k in (
            "utt_per_sec_sustained", "flush_latency_ms_p50", "flush_latency_ms_p99",
            "host_ms", "device_ms", "utt_per_sec_device_resident") if sch.get(k) is not None}
    tr = out.get("train")
    if isinstance(tr, dict):
        s["train_ms_per_step"] = _r(tr["ms_per_step"])
        if "throughput" in tr:
            s["train_ms_per_step_b512"] = _r(tr["throughput"]["ms_per_step"])
    for k in ("failed_block", "int8_gate_failed"):
        if k in out:
            s[k] = out[k]
    s["blocks"] = out.get("blocks", [])
    s["line"] = "compact_summary"
    if len(json.dumps(s)) > COMPACT_MAX:
        s.pop("bucket_fields")
    if len(json.dumps(s)) > COMPACT_MAX:
        raise AssertionError(f"compact line {len(json.dumps(s))} bytes > {COMPACT_MAX}")
    return s


def emit(out: dict, path: str | None = None) -> None:
    """The artifact so far, then the compact summary: each a whole JSON
    line, flushed; the artifact also to ``path``."""
    line = json.dumps(out)
    print(line, flush=True)
    print(json.dumps(compact_summary(out)), flush=True)
    if path:
        pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(path).write_text(line + "\n")


def run_block(out: dict, key: str, fn, path: str | None = None) -> None:
    """Run one block into ``out[key]`` and print the artifact. A block that
    raises prints what is measured so far, then the error goes on."""
    _progress(f"starting {key}")
    try:
        out[key] = fn()
    except Exception as e:
        out["failed_block"] = key
        out["error"] = f"{type(e).__name__}: {str(e)[:300]}"
        emit(out, path)
        raise
    out["blocks"].append(key)
    emit(out, path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="weights and inputs")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--json", default="chip_smoke_out/bench_h100.json",
                    help="the whole artifact, rewritten after every block")
    args = ap.parse_args(argv)
    from .device import resolve_device

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    if on_card:
        from .ops import _cuda

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _cuda.build_all()
    models = build_serving_models(args.seed)
    rng = np.random.default_rng(args.seed)
    pipe = serving_pipeline(models, dev)
    out = dict(metric="iemocap_e2e_utterances_per_sec_per_card_incl_frontends", value=None,
               unit="utterances/s/card", card=card() if on_card else "cpu",
               device=torch.cuda.get_device_name(dev) if on_card else "cpu",
               cuda_graphs=pipe.cuda_graphs, blocks=[],
               serving_precision=("int8 W8A8 end to end: the int8 attention sublayer and MHA "
                                  "kernels, the int8 FFN kernels, int8_linear; bf16 "
                                  "activations, convolutions and LayerNorms"),
               duration_mix=DURATION_MIX_NOTE, text_mix=TEXT_MIX_NOTE,
               timing=(f"median of {REPEATS} samples of {ITERS} "
                       + ("graph replays between CUDA events" if on_card else
                          "eager calls on the host clock")
                       + f"; above {SPREAD_TOL:.0%} spread {2 * REPEATS} samples of "
                       f"{2 * ITERS}; best and spread beside it"),
               mfu_note=MFU_NOTE)
    if not on_card:
        out["note"] = "eager on the CPU: host-clock times, no device metric"
    stats = {}

    def head():
        h = headline(pipe, rng)
        stats.update(h["stats"])
        out["value"] = h["utt_per_sec"]
        return {str(sec): st for sec, st in h["stats"].items()}

    run_block(out, "buckets", head, args.json)
    bf16 = serving_pipeline(models, dev, int8=False)
    out["int8_prob_delta_note"] = (f"5 s bucket, B={B}, kernels on both; gated <= "
                                   f"{INT8_PROB_DELTA_MAX} (the bench exits non-zero above "
                                   "it); random weights")
    run_block(out, "int8_prob_delta", lambda: int8_prob_delta(pipe, bf16, rng), args.json)
    if out["int8_prob_delta"] > INT8_PROB_DELTA_MAX:
        out["int8_gate_failed"] = (f"int8 prob delta {out['int8_prob_delta']:.5f} > "
                                   f"{INT8_PROB_DELTA_MAX} against bf16")
        emit(out, args.json)
        raise AssertionError(out["int8_gate_failed"])
    run_block(out, "train", lambda: bench_train(dev), args.json)
    run_block(out, "scheduler", lambda: bench_scheduler(pipe, stats), args.json)
    run_block(out, "bf16_ms_per_batch64_5s",
              lambda: measure(bf16, B, 5.0, rng, lt=LT)["ms_per_batch"], args.json)
    median_bucket = BUCKETS_S[bisect.bisect_left(BUCKETS_S, float(np.median(_duration_mix())))]
    run_block(out, "p50_ms_per_clip",
              lambda: measure(pipe, 1, median_bucket, rng, iters=20)["ms_per_batch"], args.json)
    out["p50_config"] = f"int8 B=1 at the median-duration bucket ({median_bucket} s)"
    del bf16
    run_block(out, "fusion_only_utt_per_sec", lambda: fusion_only(pipe, rng), args.json)
    return 0


if __name__ == "__main__":
    sys.exit(main())
