"""End-to-end serving: raw waveforms and texts -> emotion probabilities
(port of ``StreamingPipeline``, ``hriemo/infer/streaming.py:63-340``).

WavLM, then BERT, then the fusion model, in the compute dtype (bf16 by
default, or fp32) or, with ``int8_frontends``, W8A8, each through the port's
Hopper kernels where the JAX package routes to its TPU kernels: on the float
trees WavLM's attention core at 128..2048 frames, and on every tree the
fusion stack's audio self-attention from 1024 frames (20.5 s) on, which is
how long clips (``max_seconds`` up to 45 s and beyond) are served. Audio is
padded to the smallest length bucket that fits the batch's longest clip;
text to the smallest text bucket that covers its longest real text, which
is output-exact (BERT is mask-exact and the fused mask ORs the text mask).

The host feed overlaps the device: inputs go through pinned host memory
with a non-blocking copy, a flush enqueues its forward and, right behind
it, a non-blocking copy of its outputs into pinned host buffers of its own
with an event after that copy; its result is read one flush later, after
the next flush is enqueued, and the host then waits for that event only,
not for the next flush's forward, as the JAX package's ``np.asarray`` of
the pending flush waits for that flush alone.

On the card the forward of each input signature (shapes, dtypes; the
transport and the tree are the pipeline's) is captured once as a
``torch.cuda.CUDAGraph`` and replayed for every later flush of that shape,
the counterpart of the JAX package's one ``jax.jit`` compile per bucket
(``hriemo/infer/streaming.py:146-165``). ``cuda_graphs=False`` runs it
eagerly, as ``jax.disable_jit`` would: profiling and the kernels' launch
counters need that, since a replay launches without Python.
"""

from __future__ import annotations

import copy
import zlib

import numpy as np
import torch

from ..device import resolve_device
from ..nn.layers import set_use_kernels
from ..ops.quant import quantize_for_serving

# Per-bucket flush batches measured on an NVIDIA H100 80GB HBM3 at 700 W:
# the int8 W8A8 forward at each audio bucket and its text bucket
# (``hriemo_torch.bench.BUCKET_LT``) replayed as a CUDA graph, batches
# 32-1024 ranked by device ms per utterance, the smaller batch kept where
# two come within 1% (flush latency). ``python3 -m
# hriemo_torch.tools.bucket_batch_sweep`` takes the readings (PERF.md).
MEASURED_BUCKET_BATCH = {1.25: 384, 1.875: 256, 2.5: 192, 3.125: 128, 3.75: 128,
                         4.375: 64, 5.0: 64, 5.625: 64, 6.25: 64, 6.875: 64, 7.5: 64,
                         8.125: 32, 8.75: 32, 10.0: 32}


def capture_graph(fn, static_in, pool):
    """Capture ``fn(*static_in)`` as a ``torch.cuda.CUDAGraph`` in memory
    pool ``pool``; returns ``(graph, static outputs)``. One eager call on a
    side stream warms up first: it builds the kernels' libraries, sets their
    shared-memory attributes, loads their modules and plans cuDNN's
    convolutions, none of which a capture may do. Graphs may share a pool
    when their replays run one at a time on one stream. A capture that
    fails raises."""
    device = static_in[0].device
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn(*static_in)
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool):
        static_out = fn(*static_in)
    return graph, static_out


class HashTokenizer:
    """Deterministic whitespace + CRC32 tokenizer standing in for a real
    vocabulary: ``[1] + ids + [2]``, HF call signature."""

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def __call__(self, texts, max_length, padding="max_length", truncation=True,
                 return_tensors="np"):
        ids = np.zeros((len(texts), max_length), np.int32)
        mask = np.zeros((len(texts), max_length), np.int32)
        for i, t in enumerate(texts):
            toks = [1] + [2 + zlib.crc32(w.encode()) % (self.vocab_size - 3)
                          for w in t.lower().split()]
            toks = toks[:max_length - 1] + [2]
            ids[i, :len(toks)] = toks
            mask[i, :len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}


class StreamingPipeline:
    """Frontends + fusion inference.

    ``wavlm``/``bert``/``fusion`` are the port's modules with their weights
    loaded; the pipeline serves copies cast to ``compute_dtype`` on
    ``device`` (the card unless ``device="cpu"``), quantized when
    ``int8_frontends``/``int8_fusion``. ``use_kernels=False`` runs every
    kernel's plain PyTorch version instead, on the same device.
    ``cuda_graphs`` (default: on the card) replays one captured CUDA graph
    per input signature; False runs the forward eagerly.
    """

    def __init__(self, wavlm, bert, fusion, tokenizer=None, max_seconds: float = 10.0,
                 max_tokens: int = 128, compute_dtype=torch.bfloat16,
                 multi_label: bool = True, bucket_seconds: tuple = (),
                 int8_frontends: bool = False, int8_fusion: bool | None = None,
                 wav_transport: str = "f32", text_bucket_tokens: tuple = (),
                 device=None, use_kernels: bool = True, cuda_graphs: bool | None = None):
        if wav_transport not in ("f32", "pcm16"):
            raise ValueError(f"wav_transport must be 'f32' or 'pcm16', got {wav_transport!r}")
        self.device = resolve_device(device)
        if cuda_graphs is None:
            cuda_graphs = self.device.type == "cuda"
        elif cuda_graphs and self.device.type != "cuda":
            raise ValueError(f"cuda_graphs needs a CUDA device, the pipeline is on {self.device}")
        self.cuda_graphs = cuda_graphs
        self._graphs: dict[tuple, tuple] = {}
        self._pool = None
        self.tokenizer = tokenizer
        self.max_seconds = max_seconds
        self.max_tokens = max_tokens
        self.multi_label = multi_label
        self.wav_transport = wav_transport
        # clips between the largest bucket and the cap pad to the cap
        self.bucket_seconds = tuple(sorted(set(bucket_seconds) | {max_seconds}))
        self.text_buckets = tuple(sorted(
            {int(t) for t in text_bucket_tokens if int(t) < max_tokens} | {max_tokens}))
        self._dt = compute_dtype
        if int8_fusion is None:
            int8_fusion = int8_frontends

        def serve(model, int8):
            m = copy.deepcopy(model).to(self.device, compute_dtype).eval()
            if int8:
                quantize_for_serving(m)
            return set_use_kernels(m, use_kernels)

        self.wavlm = serve(wavlm, int8_frontends)
        self.bert = serve(bert, int8_frontends)
        self.fusion = serve(fusion, int8_fusion)

    @torch.inference_mode()
    def _forward(self, wavs, wav_arg, ids, tok_mask):
        """``(probs fp32 [B, E], beta fp32)`` on the device, enqueued: the
        captured graph of this input signature (inputs on the device or in
        pinned host memory), or the eager forward."""
        if not self.cuda_graphs:
            return self._eager(wavs, wav_arg, ids, tok_mask)
        args = (wavs, wav_arg, ids, tok_mask)
        key = tuple((tuple(a.shape), a.dtype) for a in args)
        if key not in self._graphs:
            static_in = [torch.empty_like(a, device=self.device).copy_(a, non_blocking=True)
                         for a in args]
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            self._graphs[key] = (*capture_graph(self._eager, static_in, self._pool), static_in)
        graph, static_out, static_in = self._graphs[key]
        for s, a in zip(static_in, args):
            s.copy_(a, non_blocking=True)
        return self._replay(graph, static_out)

    def release_graphs(self) -> None:
        """Drop every captured graph and their memory pool; the next flush
        of each shape captures again."""
        self._graphs.clear()
        self._pool = None

    @staticmethod
    def _replay(graph, static_out):
        graph.replay()
        # the next replay of this graph (or of one sharing its pool)
        # overwrites static_out: the result is copied out on the stream
        return tuple(o.clone() for o in static_out)

    def _eager(self, wavs, wav_arg, ids, tok_mask):
        dt = self._dt
        if self.wav_transport == "pcm16":
            # the mask is built on the device from per-clip lengths
            wav_mask = (torch.arange(wavs.shape[1], device=wavs.device)[None, :]
                        < wav_arg[:, None]).int()
            wavs = wavs.to(dt) * (1.0 / 32768.0)
        else:
            wav_mask = wav_arg
        h_a, frame_mask = self.wavlm(wavs.to(dt), wav_mask)
        h_t, _ = self.bert(ids, tok_mask)
        logits, beta, _ = self.fusion(h_a, h_t.to(dt), frame_mask == 0, tok_mask == 0)
        logits = logits.float()
        probs = torch.sigmoid(logits) if self.multi_label else torch.softmax(logits, -1)
        return probs, beta.float()

    # ---------------------------------------------------------------- host

    def _bucket_for(self, waveforms, sample_rate: int) -> float:
        longest = max(len(w) for w in waveforms) / sample_rate
        for sec in self.bucket_seconds:
            if longest <= sec:
                return sec
        return self.bucket_seconds[-1]

    def preprocess(self, waveforms, texts, sample_rate: int = 16_000):
        """Pad and tokenise a host batch (bucketed). Returns numpy
        ``(wavs, wav_arg, ids, tmask)``: ``(float32 [B, T], int32 mask [B, T])``
        under ``"f32"``, ``(int16 PCM [B, T], int32 lengths [B])`` under
        ``"pcm16"``."""
        b = len(waveforms)
        t_max = int(self._bucket_for(waveforms, sample_rate) * sample_rate)
        if self.wav_transport == "pcm16":
            wavs = np.zeros((b, t_max), np.int16)
            wmask = np.empty((b,), np.int32)
            for i, w in enumerate(waveforms):
                n = min(len(w), t_max)
                if w.dtype == np.int16:
                    wavs[i, :n] = w[:n]
                else:
                    wavs[i, :n] = np.clip(w[:n] * 32768.0, -32768, 32767).astype(np.int16)
                wmask[i] = n
        else:
            wavs = np.zeros((b, t_max), np.float32)
            wmask = np.zeros((b, t_max), np.int32)
            for i, w in enumerate(waveforms):
                n = min(len(w), t_max)
                if w.dtype == np.int16:
                    wavs[i, :n] = w[:n].astype(np.float32) * (1.0 / 32768.0)
                else:
                    wavs[i, :n] = w[:n]
                wmask[i, :n] = 1
        if self.tokenizer is None:
            raise ValueError("StreamingPipeline needs a tokenizer for text input")
        enc = self.tokenizer(texts, max_length=self.max_tokens, padding="max_length",
                             truncation=True, return_tensors="np")
        ids = np.asarray(enc["input_ids"], np.int64)
        tmask = np.asarray(enc["attention_mask"], np.int32)
        longest = int(tmask.sum(axis=1).max()) if len(texts) else 1
        for tb in self.text_buckets:
            if longest <= tb:
                ids, tmask = ids[:, :tb], tmask[:, :tb]
                break
        return wavs, wmask, ids, tmask

    # -------------------------------------------------------------- device

    def _dispatch(self, arrs, rows: int | None = None):
        """Copy a host batch to the device (pinned, non-blocking; with graphs
        straight into the graph's input buffers), enqueue its forward and
        the copy of its outputs (their first ``rows``) to the host
        (:meth:`_copy_out`). Returns the handle :meth:`_host` reads; nothing
        waits for the device."""
        ts = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]
        if self.device.type == "cuda":
            ts = [t.pin_memory() for t in ts]
            if not self.cuda_graphs:
                ts = [t.to(self.device, non_blocking=True) for t in ts]
        outs = self._forward(*ts)
        return self._copy_out(outs if rows is None else tuple(o[:rows] for o in outs))

    def _copy_out(self, outs):
        """Enqueue the copy of one flush's device outputs into pinned host
        buffers allocated for that flush, then an event: ``(host tensors,
        event)``. Each flush has buffers of its own (PyTorch's pinned-memory
        cache hands a block out again only after the copies recorded on it
        have completed and the tensor, and any numpy view of it, is gone),
        so a flush in flight never overwrites a result that was handed out.
        The copy reads the tensors that :meth:`_forward` returns (with graphs
        the clone of the graph's outputs) and is ordered before the next
        flush on the stream. On the CPU: the outputs as they are, no event."""
        if self.device.type != "cuda":
            return outs, None
        host = tuple(torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                     .copy_(o, non_blocking=True) for o in outs)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _host(self, handle):
        """numpy ``(probs, beta)`` of a flush: waits for its copy's event
        only (not for flushes enqueued after it)."""
        outs, done = handle
        if done is not None:
            done.synchronize()
        return tuple(o.numpy() for o in outs)

    def infer(self, waveforms, texts, sample_rate: int = 16_000):
        return self._host(self._dispatch(self.preprocess(waveforms, texts, sample_rate)))

    def stream(self, batches, sample_rate: int = 16_000):
        """``batches`` yields ``(waveforms, texts[, uids])``; yields
        ``(probs, beta, uids)`` one batch behind, in order."""
        pending = None
        for batch in batches:
            uids = batch[2] if len(batch) > 2 else None
            result = self._dispatch(self.preprocess(batch[0], batch[1], sample_rate))
            if pending is not None:
                yield (*self._host(pending[0]), pending[1])
            pending = (result, uids)
        if pending is not None:
            yield (*self._host(pending[0]), pending[1])

    def stream_bucketed(self, clips, sample_rate: int = 16_000,
                        bucket_batch: dict | None = None, default_batch: int = 64,
                        pad_flush: bool = False):
        """One queue per audio bucket, flushed when it reaches that bucket's
        batch size (``bucket_batch``, by default :data:`MEASURED_BUCKET_BATCH`,
        the batches measured on the card; ``default_batch`` for a bucket it
        does not list); partial queues flush at the end. ``clips`` yields
        ``(waveform, text[, uid])``; yields ``(probs, beta, uids)`` per
        flush, not in arrival order. ``pad_flush`` pads partial flushes to
        the batch size with silent 10 ms clips, so each bucket keeps one
        batch shape (one graph).
        """
        if bucket_batch is None:
            bucket_batch = MEASURED_BUCKET_BATCH
        queues: dict[float, list] = {sec: [] for sec in self.bucket_seconds}
        pending = None

        def dispatch(sec):
            q = queues[sec]
            if not q:
                return None
            queues[sec] = []
            n = len(q)
            target = bucket_batch.get(sec, default_batch)
            if pad_flush and n < target:
                q = q + [(np.zeros(sample_rate // 100, np.float32), "", None)] * (target - n)
            handle = self._dispatch(self.preprocess(
                [c[0] for c in q], [c[1] for c in q], sample_rate), rows=n)
            return handle, [c[2] for c in q[:n]]

        def flushes():
            for i, clip in enumerate(clips):
                uid = clip[2] if len(clip) > 2 else i
                sec = self._bucket_for([clip[0]], sample_rate)
                queues[sec].append((clip[0], clip[1], uid))
                if len(queues[sec]) >= bucket_batch.get(sec, default_batch):
                    yield dispatch(sec)
            for sec in self.bucket_seconds:
                out = dispatch(sec)
                if out is not None:
                    yield out

        for out in flushes():
            if pending is not None:
                yield (*self._host(pending[0]), pending[1])
            pending = out
        if pending is not None:
            yield (*self._host(pending[0]), pending[1])
