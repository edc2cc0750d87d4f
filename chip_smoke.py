#!/usr/bin/env python3
"""Drive the PyTorch port (``hriemo_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, any failure exits non-zero:

1. the card's name and power limit (nvidia-smi);
2. build every kernel from ``hriemo_torch/csrc`` (nvcc, one process per
   source, in parallel) into ``hriemo_torch/_build/``;
3. each kernel against its plain PyTorch version on the card at the serving
   paths' shapes: max |error| against the stated tolerance (``TOL`` for
   sublayer outputs, ``ATTN_TOL`` for the raw outputs of the attention cores,
   which also rejects a streaming result that drops the last, partial key
   block and a gated one-pass result that drops its last, partial key tile,
   each in bf16 and in fp32 at its kernel's key tile; ``CONV_TOL`` for the
   conv-stack stages, which also rejects, in bf16 and fp32, a K1 result whose
   conv1 row and a K2 result whose conv4 row at the edge of a 128-row GEMM
   tile drops its third tap; ``STATS_TOL`` for the GroupNorm sums, which also
   rejects a result without the last, partial chunk of conv0 rows, and the
   stats kernel must give the same bits on two calls), and CUDA-event times of
   the kernel, the plain version and, where one PyTorch call computes the same
   function, that call (``library_ms``, a yardstick the port never calls, and
   ``ms / library_ms``), beside the least time the card could take; for the
   float FFN and the conv stack, the routed path's time (``route_ms``: cuBLAS
   and LayerNorm; the Gram-matrix GroupNorm statistics for the stats, cuDNN
   conv4..6 for K2, cuDNN ``_feature_encoder`` for the fused stack) instead;
   then the two kernels under the int8 wrappers alone, beside their own
   yardsticks: the int8 attention core (``attention_core_int8``) against SDPA,
   with its own limit check (a gated B=4 L=499 result without its last key
   tile), and the shared int8 GEMM at the 10 s bucket's rows, bit-equal to its
   plain version, against ``torch._int_mm``; phase 4 then gives each of these
   rows its launches per forward. The one-pass and streaming cores are also
   held at phase 7d's shapes (4 heads of 64, a long split padded to
   ``mosei_eval_infer``'s batch), where ``ATTN_TOL`` must reject each
   without its last, partial key tile; then in fp16 (the gated core at B=2
   L=1499, the one-pass and streaming cores at phase 7d's shapes and at the
   long clips' 8 heads of 96, SDPA in fp16 beside each, each held at
   ``ATTN_TOL[fp16]``, which must reject each without its last key tile),
   and the flash cores at head dims beside 64 and 96 at phase 7d's lengths:
   32 (d=256 in 8 heads) in bf16, fp16 and fp32, 2 heads of 128 in bf16 and
   fp32, 8 heads of 40 in bf16, and on the wide tiles in bf16, fp16 and fp32
   one head of 256 (the MOSEI model at ``--n_heads 1``, phase 7d's shapes)
   and 4 heads of 192 (the IEMOCAP decoder at ``--n_heads 4``, the long
   clips' lengths), each on the tile instance that the C
   dispatch names (the kernel that its library records at the launch and
   torch.profiler's trace shows: never a CUDA-core one), held at ``ATTN_TOL``, which must reject each without its last key
   tile, and timed beside the CUDA-core kernel that served it before and
   SDPA (a wide row must beat its CUDA-core kernel; fp32 rows are bound at
   three TF32 products); then the int8 core
   alone at B=4 self 499² on the tiles at d=256 in 8 heads and d=768 in 6
   and 4 (hd 32, 128, 192), against SDPA, the hd-192 one also held without
   its last key tile;
4. the int8 serving path end to end at full width (WavLM base-plus,
   BERT-base, fusion 768/8 heads/2/2/256/4 emotions, W8A8, pcm16 transport,
   text buckets 8..64, random weights from a seed): 16 requests across the
   2.5 s and 10 s audio buckets, launch counts per forward, probabilities
   finite and in [0, 1], and the same requests through the plain versions
   (``use_kernels=False``) within the int8 gate of 0.006; then the same on
   the int8 tree at fp32 compute (``compute_dtype=torch.float32``), whose
   int8 sublayers take and store fp32 activations;
4b. the bf16 tree (``int8_frontends=False``, the pipeline's default) on the
   same 16 requests: launch counts, kernel vs plain within 0.006, and
   ``int8_prob_delta``, the max |int8 - bf16| probability with kernels on
   both, gated at 0.006 as ``bench.py`` gates it;
4c. long clips (``max_seconds=45``, buckets 10/30/45 s, batch 2): two clips
   of 28-30 s and two of 42-45 s on the bf16, int8, fp32 and int8-at-fp32
   trees, launch
   counts per forward (WavLM attention 1499 frames on the fused gated-bias
   kernel, 2249 per op; fusion self-attention on the one-pass and the
   streaming kernel) and kernel vs plain within 0.006;
4d. the int8 tree with the fusion model at d=768 in 4 heads (hd 192) on
   phase 4's 16 requests: the fusion stack's 8 MHA sublayers a forward run
   their core on the wide tile instance (launch counts), kernel vs plain
   within 0.006;
5. the feature-extraction entry point at full width (WavLM base-plus and
   BERT-base, random weights from a seed): a synthetic IEMOCAP tree of 24
   utterances, the port's index builder, ``extract_iemocap`` audio (seq and
   utter, fp32 and bf16, batch 8, 10 s) and text (seq, 128 tokens), then
   ``check_integrity``; launch counts per audio forward, features with
   kernels vs ``use_kernels=False``, utterances per second; then a
   forced-gate run (the conv-stack and float-FFN gates monkeypatched on for
   one batch) that must launch the three conv-stack kernels once and the
   FFN kernel 12 times per forward and match the routed features;
6. training: (a) the IEMOCAP decoder trainer's ``main`` at its full width
   (d=768, 8 heads, 2+2 layers, beta hidden 256, dropout 0.1) on a synthetic
   seq-level corpus of 48 utterances up to its caps (500 audio, 128 text
   frames), batch 16, two epochs in fp32 and in bf16: losses finite, the
   checkpoint loads strictly into ``FusionWithEmotionDecoder``; (b) the
   MOSEI trainer at its defaults (d=256, bf16 over fp32 masters, batch 8 x
   grad_accum 4, warmup-cosine) on ``make_synthetic_mosei`` data up to
   300/128 frames, 21 steps: losses finite, the reported lr on the warmup
   and cosine; (c) train steps of the full-width fusion model at B=2,
   dropout 0, audio at 1499 and 2249 frames with padding, fp32 and bf16:
   the one-pass or streaming kernel forward launched twice a step, and
   against the plain route (``use_kernels=False``) the loss within
   ``LOSS_RTOL``, the gradients within ``GRAD_TOL`` in relative norm (each
   leaf in fp32, the whole gradient in bf16), and a lower peak step memory;
   the gradient tolerance must reject a flash backward that drops its last,
   partial 512-key block; the same steps of ``MoseiFusionWithEmotionDecoder``
   at the MOSEI trainer's d=256 in 8 heads (hd 32, 6 emotions) and of the
   IEMOCAP decoder at d=768 in 4 heads (hd 192, the wide tiles; fp32 with
   the whole gradient within ``GRAD_TOL`` and at most
   ``WIDE_MAX_RELU_FLIPS`` FFN ReLU flips, the worst leaf printed; bf16
   with the loss within ``WIDE_LOSS_RTOL``); then
   ``wavlm_fused_attention``'s gradient at B=2 L=499, 12 heads of 64, bf16
   and fp32: the forward within ``ATTN_TOL``,
   the gradients bit-equal to the plain route's; (d) ``train_fusion_seq_level``
   at its full width (``FusionClassifier``, d=768, dropout 0.2) on (a)'s
   corpus, fp32 and bf16, two epochs, then ``FusionClassifier`` train steps
   at 1499 and 2249 frames against the plain route as in (c); (e)
   ``train_fusion_utter_level`` at full width (batch 32) on a synthetic
   utter-level corpus of 160, both baselines on it, and the MOSEI trainer at
   its defaults for 2 epochs with ``--resume``, resumed to 4 with
   ``--trace_dir``: the restored train state equal to the saved one leaf by
   leaf, the log going on at epoch 3, one trace written. Each prints step
   ms (wall and CUDA events), steps per second and peak memory;
7. evaluation and inference on phase 5's tree and phase 6's checkpoints,
   each entry point's ``main`` called in this process: (a) HF-layout state
   dicts of phase 5's encoders (prefixed names, the positional conv as
   weight norm's g and v, a pooler and ``position_ids`` to skip) and a
   WordPiece vocabulary of the transcripts load through the bridges: BERT
   bit-equal to its source, WavLM within the fp32 feature limit; (b)
   ``e2e_infer`` on the index's test split with those files and phase 6a's
   checkpoint, W8A8 and bf16, each against the same CLI on the plain
   versions within 0.006, rows 1-4 launched on W8A8 and the WavLM core on
   bf16, utterances per second of the whole call; (c) ``extract_iemocap``
   with the local files, fp32, one batch, kernels vs plain at 1e-4; (d)
   ``mosei_eval_infer`` on phase 6b's checkpoint with ``--dump_beta
   --dump_attn`` (artifact shapes, ``y_prob`` unchanged without the dump),
   ``mosei_summary_metrics``, then uncapped over a one-pass and a streaming
   split (1100-2300 audio frames) against the plain versions at phase 6c's
   bf16 limit, launching both flash kernels, in bf16, again in fp16, and in
   bf16 with the checkpoint at ``--n_heads 8`` (hd 32) and ``--n_heads 1``
   (hd 256, the wide tiles), and at ``--amp_dtype off --n_heads 1`` (fp32 on
   the wide tiles);
8. (a) every serving kernel against its plain version at every audio bucket
   (``hriemo_torch.tools.kernel_numerics``: 45 rows, B=8, full width, the
   JAX tool's limits; ``chip_smoke_out/kernel_numerics_h100.json``); (b)
   ``int8_numerics_report`` on WavLM base-plus, BERT-base and the fusion
   model (d=768, fp32, seed 0) with 4 requests through the kernels, on clean
   weights and with an outlier channel in one WavLM FFN: the envelope must be
   blown, the layer downstream of the outlier reverted first and the result
   end within it; the reverted tree then serves through the kernels, its
   split FFN per op and every whole block on its kernel (launch counts), and
   within 0.006 of its plain route, as do trees with one Linear of a BERT
   MHA and of a WavLM attention sublayer kept in full precision; (c) the C++ feature loader built from
   the checkout, ``BucketBatcher(native=True)`` bit-equal to the Python
   loader on phase 6b's corpus, and one epoch of the MOSEI trainer with
   ``--native_loader`` on the C++ loader;
9. the (data x model) mesh at full width (``hriemo_torch/parallel``), two
   ranks sharing the card over gloo with CUDA tensors (NCCL puts no two
   ranks on one device; this measures correctness, not scaling): (a) train
   steps of phase 6c's fusion model (dropout 0, B=4, 2 rows a rank, audio
   at 1499 and 2249 frames, fp32 and bf16, the flash kernels forward and
   their recompute backward on each rank) over the data axis against the
   single-process step on the whole batch: loss within ``LOSS_RTOL``,
   gradients (averaged over the data group) within ``GRAD_TOL`` as in 6c,
   parameters after the step within ``PARAM_TOL``; then the same at dropout
   0.1; (b) the same steps over the model axis (the FFNs tensor-parallel);
   (c) the MOSEI trainer at phase 6b's corpus and defaults with ``--n_data
   1`` (one NCCL rank), its losses bit-equal to 6b's, and ``--n_data 2``
   (two gloo ranks), within ``LOSS_RTOL[bf16]``; (d) each data rank serving its
   half of phase 4's 16 requests on the W8A8 and the bf16 trees through
   the kernels, then gathering every request's probabilities over the data
   group: all 16 on each rank within 5e-3 of phase 4's
   (``__graft_entry__.py:322-331``); (e) ring attention at one rank on the
   card against full attention at [2, 8, 2249, 96] bf16 within
   ``ATTN_TOL`` (across ranks it waits for a card per rank: gloo moves no
   CUDA tensors point to point). The ranks send their launches back;
   each sub-phase prints its wall time, and the steps their ms over the
   mesh and in one process;
10. the serving bench's path (``hriemo_torch.bench``): ``StreamingPipeline``
   replaying one CUDA graph per input signature against the same pipeline
   eager (``cuda_graphs=False``, as phases 4-9 serve, so that the launch
   counters count every forward) on the W8A8 and the bf16 trees at the 2.5 s
   and 10 s buckets, probabilities and beta bit-equal, twice; three
   back-to-back flushes of the 10 s bucket through ``stream_bucketed(
   pad_flush=True)``, one graph, each flush bit-equal to its eager result;
   then the bench's bucket measurement at those two buckets at their
   ``MEASURED_BUCKET_BATCH`` (three repeats; ``mfu`` in (0, 1]) and its
   scheduler block on 256 clips of its stream, each printed as a JSON line;
11. a JSON line ``{"kernels": [...]}`` (launches over the main-path runs of
   phases 4-9; the wide tile instances as entries of their own); then the
   last line ``{"ok": true, "device": {...}}``.

``--outlier-sweep`` instead runs only phase 8b's outlier over layers and
scales (the readings its constants were chosen from) after the build.
Full per-shape results go to ``chip_smoke_out/chip_smoke.json``. With
``--profile`` it also traces one pass of each serving run and one train step
of each phase-6c configuration with torch.profiler
(``chip_smoke_out/profile_<run>.txt``).
"""

from __future__ import annotations

import copy
import csv
import functools
import json
import math
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from hriemo_torch.frontends import BertConfig, BertEncoder, WavLMConfig, WavLMEncoder
from hriemo_torch.infer import HashTokenizer, StreamingPipeline
from hriemo_torch.models import (FusionClassifier, FusionWithEmotionDecoder,
                                  MoseiFusionWithEmotionDecoder)
from hriemo_torch.data import load_feature, save_feature, write_meta
from hriemo_torch.dataprep import extract_iemocap as EX
from hriemo_torch.dataprep import iemocap_index as II
from hriemo_torch.dataprep.integrity import check_integrity
from hriemo_torch.nn.layers import (Linear, MLP2, gelu, init_torch_defaults, layer_norm,
                                    set_use_kernels)
from hriemo_torch.nn.attention import MultiheadAttention
from hriemo_torch.ops import _cuda
from hriemo_torch.ops import attention_block as AB
from hriemo_torch.ops import conv_stack as CS
from hriemo_torch.ops import flash_attention as FA
from hriemo_torch.ops import fused_ffn as FF
from hriemo_torch.ops import quant as Q
from hriemo_torch.ops import wavlm_attention as WA
from hriemo_torch.ops.quant import quantize_for_serving
from hriemo_torch.data.synthetic import MOSEI_EMO_COLS, make_synthetic_iemocap, make_synthetic_mosei
from hriemo_torch.parallel import train_step as TS
from hriemo_torch.train import linear_probe_baseline as TRAIN_PROBE
from hriemo_torch.train import train_fusion_seq_level as TRAIN_SEQ
from hriemo_torch.train import train_fusion_seq_level_decoder as TRAIN_IEMOCAP
from hriemo_torch.train import train_fusion_utter_level as TRAIN_UTT
from hriemo_torch.train import train_mosei_fusion_seq_level_decoder as TRAIN_MOSEI
from hriemo_torch.train import train_text_baseline as TRAIN_TEXT
from hriemo_torch.utils import checkpoint as CK
from hriemo_torch.dataprep.tokenization import WordPieceTokenizer
from hriemo_torch.infer import e2e_infer as E2E
from hriemo_torch.infer import mosei_eval_infer as MEVAL
from hriemo_torch.infer import mosei_summary_metrics as MSUM
from hriemo_torch.utils.checkpoint import load_torch_checkpoint, save_torch_checkpoint

SEED = 0
B = 4                     # requests per flush on the serving path below
TOL = dict(atol=5e-2, rtol=5e-2, median=5e-3)  # tests/test_attention_block.py:111-115
# Attention cores' raw outputs are a few hundredths at these lengths, so they
# get their own limits, set from the card's readings (PERF.md, PR 2): bf16
# max |error| 0.00098-0.00195 and median 0, fp32 max 9.5e-7. The median is
# taken per batch element, so an error confined to one element's rows fails.
ATTN_TOL = {torch.bfloat16: dict(atol=8e-3, rtol=1e-2, median=1e-3, per_batch=True),
            torch.float32: dict(atol=1e-4, rtol=1e-4, median=1e-5, per_batch=True),
            torch.float16: dict(atol=1e-3, rtol=1e-3, median=1.25e-4, per_batch=True)}
# Conv-stack stage outputs (GELU activations of O(1)) get their own limits,
# set from the card's readings (PERF.md §6): bf16 max |error| 0.0156 (one
# bf16 step below 4) and median 0; fp32 max 1.2e-5, median 2.4e-7. A K1
# result whose conv1 row at a GEMM tile's edge drops its third tap reads max
# 0.68 (bf16) and 0.72 (fp32), median 0, and must fail.
CONV_TOL = {torch.bfloat16: dict(atol=3e-2, rtol=1e-2, median=1e-3, per_batch=True),
            torch.float32: dict(atol=1e-4, rtol=1e-4, median=1e-5, per_batch=True)}
# GroupNorm sums (of order 1e3-1e4 at 10 s): readings max 0.0137, median 1.4e-4.
# A result without the last, partial chunk of conv0 rows must fail.
STATS_TOL = dict(atol=1e-2, rtol=1e-4, median=1e-3)
FP32_TOL = dict(atol=2e-4, rtol=0.0, median=2e-5)  # fp32 sublayer outputs near 1
PROB_GATE = 0.006         # bench.py INT8_PROB_DELTA_MAX
# NVIDIA H100 SXM data sheet, dense: HBM bytes/s, int8 and bf16 tensor-core op/s,
# fp32 op/s outside the tensor cores, TF32 tensor-core op/s
PEAK_BYTES, PEAK_INT8, PEAK_BF16, PEAK_FP32 = 3.35e12, 1979e12, 989e12, 67e12
PEAK_TF32 = 495e12
# The fp32 attention cores at head dims 64 and 96, the fp32 float FFN and
# the conv stack's fp32 convs (K1's and K2's) run 3xTF32: three TF32 products for each fp32 one
# (csrc/attention_tf32.cuh, csrc/float_wgmma.cuh), so their bound is three
# times the fp32 GEMM operations at the TF32 rate
TF32_PRODUCTS = 3
TEXT_BUCKETS = (8, 12, 16, 20, 24, 32, 64)   # bench.py:172
EPS = 1e-5                # WavLM's layer_norm_eps (GroupNorm)
ONEPASS_KEY_TILE = 64     # keys per tile of the bf16 one-pass kernels (csrc/onepass_mma.cuh)
TF32_KEY_TILE = 32        # keys per tile of the fp32 kernels (csrc/attention_tf32.cuh)
OUT = pathlib.Path("chip_smoke_out")
_MAKE_TRAIN_STEP = TS.make_train_step   # the trainers' step, before run_trainer wraps it

# (wrapper, TPU kernel it replaces, CUDA sources) for the kernels line
KERNELS = {
    "attention_block_int8": (AB.attention_block_int8,
                             "hriemo/ops/attention_block.py:169",
                             "hriemo_torch/csrc/attention.cu"),
    "mha_block_int8": (AB.mha_block_int8, "hriemo/ops/attention_block.py:508",
                       "hriemo_torch/csrc/attention.cu"),
    "ffn_block_int8": (FF.ffn_block_int8, "hriemo/ops/fused_ffn.py:94",
                       "hriemo_torch/csrc/quant_gemm.cu"),
    "mlp2_int8": (FF.mlp2_int8, "hriemo/ops/fused_ffn.py:71",
                  "hriemo_torch/csrc/quant_gemm.cu"),
    # int8_linear is XLA's int8 dot in the JAX package, not a Pallas kernel
    "int8_linear": (Q.int8_linear, "hriemo/ops/quant.py:85",
                    "hriemo_torch/csrc/quant_gemm.cu"),
    "wavlm_fused_attention": (WA.wavlm_fused_attention, "hriemo/ops/wavlm_attention.py:34",
                              "hriemo_torch/csrc/wavlm_attention.cu"),
    "onepass_attention": (FA.onepass_attention, "hriemo/ops/flash_attention_pallas.py:81",
                          "hriemo_torch/csrc/wavlm_attention.cu"),
    "streaming_attention": (FA.streaming_attention, "hriemo/ops/flash_attention_pallas.py:38",
                            "hriemo_torch/csrc/flash_attention.cu"),
    "ffn_block_bf16": (FF.ffn_block_bf16, "hriemo/ops/fused_ffn.py:112",
                       "hriemo_torch/csrc/ffn_bf16.cu"),
    "conv_stack_stats": (CS.conv_stack_stats, "hriemo/ops/conv_stack.py:108",
                         "hriemo_torch/csrc/conv_stack.cu"),
    "conv_stack_k1": (CS.conv_stack_k1, "hriemo/ops/conv_stack.py:128",
                      "hriemo_torch/csrc/conv_stack.cu"),
    "conv_stack_k2": (CS.conv_stack_k2, "hriemo/ops/conv_stack.py:152",
                      "hriemo_torch/csrc/conv_stack.cu"),
}
# the wide tile instances (HD 192 and 256, csrc/attention_tiles.cuh) as
# entries of their own in the kernels line: (TPU kernel, CUDA source). Their
# launches are the wrappers' at head dims above 128 in bf16 or fp16, by the
# head-dim and shape counters (every int8 core launch above 128 on these
# paths is an MHA sublayer's, ungated).
WIDE_KERNELS = {
    "onepass_attention (wide tiles)": ("hriemo/ops/flash_attention_pallas.py:81",
                                       "hriemo_torch/csrc/onepass_mma.cuh"),
    "streaming_attention (wide tiles)": ("hriemo/ops/flash_attention_pallas.py:38",
                                         "hriemo_torch/csrc/flash_attention.cu"),
    "attention_core_int8 (wide tiles)": ("hriemo/ops/attention_block.py:508",
                                         "hriemo_torch/csrc/onepass_mma.cuh"),
}
LAUNCH_NAMES = (*KERNELS, *WIDE_KERNELS)
# the two kernels under the int8 wrappers, counted by shape too
COUNTED_BY_SHAPE = (AB.attention_core_int8, _cuda.int8_gemm)
COUNTED_BY_HEAD_DIM = (FA.onepass_attention, FA.streaming_attention)
# launches of each wrapper in one forward of the int8 serving path (2.5 s
# and 10 s buckets); every wrapper not named launches 0 times
PER_FORWARD = {"attention_block_int8": 12, "mha_block_int8": 20, "ffn_block_int8": 24,
               "mlp2_int8": 5, "int8_linear": 21}
# of the 20 MHA sublayers, the fusion stack's (the other 12 are BERT's)
FUSION_MHA_PER_FORWARD = 8
# the bf16 tree: WavLM attention on the fused kernel at 499 frames (10 s),
# per op at 124 (2.5 s, below its 128-frame gate)
PER_FORWARD_BF16 = {10.0: {"wavlm_fused_attention": 12}, 2.5: {}}
# long clips, per forward: WavLM attention at 1499 frames (30 s) on the
# fused kernel, at 2249 (45 s) per op; the fusion stack's two audio
# self-attentions on the one-pass kernel up to 2048 keys, streaming beyond
PER_FORWARD_LONG = {30.0: {"wavlm_fused_attention": 12, "onepass_attention": 2},
                    45.0: {"streaming_attention": 2}}
# feature extraction, per WavLM forward at 10 s (499 frames): routed, and
# with the conv-stack and float-FFN gates forced on
PER_FORWARD_EXTRACT = {"wavlm_fused_attention": 12}
PER_FORWARD_FORCED = {"wavlm_fused_attention": 12, "ffn_block_bf16": 12,
                      "conv_stack_stats": 1, "conv_stack_k1": 1, "conv_stack_k2": 1}
# training: the gradient of the fusion step, kernel route against the plain
# one, in relative norm |g - r| <= tol |r|: in fp32 each leaf within 1e-4,
# in bf16 the whole gradient (all leaves together) within 5e-2. Element by
# element the routes are not comparable at these limits: a ReLU
# pre-activation within a rounding step of zero is on in one route and off
# in the other, and adds or drops one row's term of the FFN weight's
# gradient. The card read 4.1e-4 of max |g| at the first fusion FFN's W1 at
# L=1499 in fp32 (2.5e-5 in norm), and in bf16 5.0e-2 in norm at the
# decoder's last linear1, whose ReLU sees only B x E = 8 rows (PERF.md §6).
# The FusionClassifier step (phase 6d) is held on its whole gradient in fp32
# too: its loss reaches the audio rows mostly through the 128 fused rows (the
# text's length), so the row a ReLU flip changes is a large share of some
# leaves (the card read 8.1e-4 in norm at layer 1's audio FFN W1 and 3.0e-4
# at layer 0's self_norm_a weight, 4.4e-5 and 2.2e-5 for the whole
# gradient); the flips are counted: 5 in fp32 on the card, where a wrong
# forward would flip thousands of the step's 20-30M FFN pre-activations
# (bf16 flips thousands by its own rounding: 4541 at 1499 frames).
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
# the bf16 step of the decoder at 4 heads of 192 (the wide tiles): its loss
# is held at a tenth of LOSS_RTOL[bf16] (the fp32 one at LOSS_RTOL[fp32])
WIDE_LOSS_RTOL = 1e-3
MAX_RELU_FLIPS = 100
# the decoder's fp32 step at 4 heads of 192 is held on its whole gradient
# too (phase 6c), with a flip limit of its own: the card read 4 and 5 flips
# there and 3-11 on other batches (chip_grad_flip_probe.py), where a wrong
# forward flips thousands
WIDE_MAX_RELU_FLIPS = 20
LOSS_RTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# evaluation and inference: the kernels each e2e_infer tree must launch, the
# uncapped MOSEI splits (audio frames: one-pass up to 2048 keys, streaming
# beyond; d=256 and 4 heads, so the audio self-attention of both fusion
# layers, 2 launches a split), and their kernel-vs-plain limit on
# probabilities, phase 6c's bf16 forward limit. A limit on probabilities
# cannot show a wrong core, so phase 3 holds both cores at these shapes at
# ATTN_TOL, which rejects each without its last key tile.
E2E_KERNELS = {"int8": ("attention_block_int8", "mha_block_int8", "ffn_block_int8", "mlp2_int8"),
               "bf16": ("wavlm_fused_attention",)}
LONG_MOSEI = {"long_onepass": (1100, 2000), "long_streaming": (2100, 2300)}
EVAL_TOL = LOSS_RTOL[torch.bfloat16]
TRAIN_AUDIO = (1499, 2249)   # one-pass and streaming audio self-attention (30 s, 45 s)
EXTRACT_ENVELOPE = dict(atol=0.15, rtol=0.15)  # tests/test_conv_stack.py bf16 vs fp32
# Extracted features: fp32 at the encoders' 1e-4 (tests/test_torch_frontends.py).
# bf16 hidden states are 12 layers deep, not one sublayer as TOL is: one
# bf16 rounding flipped in the attention core spreads across the row at the
# next LayerNorm, so the card reads a median |d| of one bf16 step at |x| in
# [1, 2) (0.0078) and max 0.094, with 6 of 9.2M elements outside TOL's
# allclose (PERF.md §6). Held at two such steps and the bf16 envelope.
FEATURE_TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
               "bfloat16": dict(EXTRACT_ENVELOPE, median=2e-2)}


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device ms of one call of ``fn``: ``iters`` calls are captured in one
    CUDA graph and the graph's replay is timed with CUDA events, so the
    host's Python and ctypes overhead between launches is not counted
    (timed call by call, it dominates the smaller shapes)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: int, int8_ops: int = 0, bf16_ops: int = 0, fp32_ops: int = 0,
          tf32_ops: int = 0):
    """Least time (ms) for the work: the larger of bytes over the memory
    rate and operations over the peak rate of their type."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = (int8_ops / PEAK_INT8 + bf16_ops / PEAK_BF16 + fp32_ops / PEAK_FP32
             + tf32_ops / PEAK_TF32)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def compare(name, got, ref, tol=TOL):
    """Kernel vs plain on the same inputs: allclose + median (when ``tol``
    has one), as the JAX kernel tests hold their interpret-mode kernels.
    Returns the max and the (largest per batch element, with
    ``per_batch``) median |error|."""
    got, ref = got.float(), ref.float()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)} "
                             "or non-finite output")
    diff = (got - ref).abs()
    bad = diff > tol["atol"] + tol["rtol"] * ref.abs()
    med = (diff.flatten(1).median(dim=1).values.max() if tol.get("per_batch")
           else diff.median()).item()
    if bad.any() or med >= tol.get("median", math.inf):
        raise AssertionError(f"{name}: {int(bad.sum())} elements outside atol {tol['atol']} "
                             f"rtol {tol['rtol']}, max |d| {diff.max().item():.4g}, "
                             f"median {med:.3g} (limit {tol.get('median')})")
    return diff.max().item(), med


def quantized(module):
    return quantize_for_serving(module.to("cuda", torch.bfloat16).eval())


def check_kernels(gen):
    """Phase 3. Returns one record per (kernel, shape), and the readings of
    the deliberately wrong results under ``ATTN_TOL`` and ``CONV_TOL``."""
    dev = torch.device("cuda")
    rows = []

    def randn(*shape, scale=1.0, dtype=torch.bfloat16, generator=None):
        return (torch.randn(*shape, generator=generator or gen) * scale).to(dev, dtype)

    def mask(b, l, generator=None):
        lens = torch.randint(l // 2, l + 1, (b,), generator=generator or gen)
        lens[0] = l
        return (torch.arange(l)[None, :] >= lens[:, None]).to(dev)

    def run(kernel, shape, fn, plain, library, nbytes_, int8_ops, bf16_ops, fp32_ops=0,
            tf32_ops=0, tol=TOL, route=None):
        got, ref = fn(), plain()
        torch.cuda.synchronize()
        err, med = compare(f"{kernel} {shape}", got, ref, tol)
        b_ms, b_by = bound(nbytes_, int8_ops, bf16_ops, fp32_ops, tf32_ops)
        rec = dict(kernel=kernel, shape=shape, max_abs_err=err, median_abs_err=med,
                   ms=cuda_ms(fn), plain_ms=cuda_ms(plain),
                   library_ms=None if library is None else cuda_ms(library),
                   route_ms=None if route is None else cuda_ms(route),
                   bound_ms=b_ms, bound_by=b_by)
        rec["ms_over_library"] = None if library is None else rec["ms"] / rec["library_ms"]
        rows.append(rec)
        vs_lib = "" if library is None else f" (ms / library_ms {rec['ms_over_library']:.3f})"
        print(f"  {kernel:22s} {shape:28s} max|d| {err:.3g} (median {med:.2g}) "
              f"kernel {rec['ms']:.4f} ms  plain {rec['plain_ms']:.4f} ms  "
              f"library {rec['library_ms'] if library else None}{vs_lib}  "
              f"route {rec['route_ms'] if route else None}  bound {b_ms:.4f} ms ({b_by})",
              flush=True)
        return got, ref

    # WavLM attention sublayer, the 10 s bucket
    d, h, hd = 768, 12, 64
    enc = WavLMEncoder(WavLMConfig(num_hidden_layers=1))
    enc.init_weights(gen)
    layer = quantized(enc.encoder.layers[0])
    for l in (124, 499):  # the 2.5 s and 10 s buckets
        x = randn(B, l, d)
        pos = randn(h, l, l, scale=0.3)
        kb = torch.where(mask(B, l), AB.NEG_INF, 0.0).float()
        ops = layer.attn_ops
        q, k, v = (randn(B, h, l, hd) for _ in range(3))
        gp = (pos[None].float() + kb[:, None, None, :]).to(torch.bfloat16)
        m = B * l
        run("attention_block_int8", f"B={B} L={l}",
            lambda: AB.attention_block_int8(x, ops, pos, kb, 1e-5),
            lambda: AB.attention_block_int8_plain(x, ops, pos, kb, 1e-5),
            lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=gp),
            nbytes(x, pos, kb, x) + 4 * d * d + 4 * (4 * d) * 2,
            8 * m * d * d, 4 * B * h * l * l * hd + 2 * m * d * 8)

    # MHA sublayers: BERT self (12 x 64) and fusion self/cross (8 x 96)
    cases = [(12, 16, 16, True), (12, 64, 64, True), (8, 499, 499, True),
             (8, 16, 499, False), (8, 499, 16, False), (8, 64, 499, False),
             (8, 499, 64, False)]
    mhas = {}
    for h, lq, lk, self_attn in cases:
        if h not in mhas:
            mod = MultiheadAttention(d, h)
            init_torch_defaults(mod, gen)
            mhas[h] = quantized(mod).ops
        ops, hd = mhas[h], d // h
        xq = randn(B, lq, d)
        xkv = xq if self_attn else randn(B, lk, d)
        kpm = mask(B, lk)
        q, k, v = randn(B, h, lq, hd), randn(B, h, lk, hd), randn(B, h, lk, hd)
        amask = ~kpm[:, None, None, :]
        mq, mk = B * lq, B * lk
        run("mha_block_int8", f"B={B} {'self' if self_attn else 'cross'} {lq}x{lk} H={h}",
            lambda: AB.mha_block_int8(xq, xkv, ops, kpm),
            lambda: AB.mha_block_int8_plain(xq, xkv, ops, kpm),
            lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=amask),
            nbytes(xq, kpm, xq) + (0 if self_attn else nbytes(xkv)) + 4 * d * d + 4 * 4 * d * 2,
            2 * mq * d * d * 2 + 2 * mk * d * 2 * d, 4 * B * h * lq * lk * hd)

    # FFN block (WavLM 10 s bucket rows), mlp2 (fusion FFN and beta gate)
    f = 3072
    ff = MLP2(d, f, d)
    init_torch_defaults(ff, gen)
    ff = quantized(ff)
    ln_w, ln_b = randn(d, dtype=torch.float32).abs(), randn(d, scale=0.1, dtype=torch.float32)
    fops = FF.FfnOperands(ff.ops, ln_w, ln_b)
    m = B * 499
    x = randn(m, d)
    run("ffn_block_int8", f"M={m} {d}->{f}->{d}",
        lambda: FF.ffn_block_int8(x, fops, 1e-5, True),
        lambda: FF.ffn_block_int8_plain(x, fops, 1e-5, True), None,
        nbytes(x, x) + 2 * d * f + 4 * (2 * f + 4 * d), 4 * m * d * f, 0)
    for din, fh, dout, mm in ((d, f, d, m), (4 * d, 256, d, B)):
        mod = MLP2(din, fh, dout)
        init_torch_defaults(mod, gen)
        ops = quantized(mod).ops
        x = randn(mm, din)
        run("mlp2_int8", f"M={mm} {din}->{fh}->{dout}",
            lambda: FF.mlp2_int8(x, ops), lambda: FF.mlp2_int8_plain(x, ops), None,
            nbytes(x) + mm * dout * 2 + (din + dout) * fh + 8 * (fh + dout),
            2 * mm * fh * (din + dout), 0)

    # int8_linear: WavLM's feature projection on the 10 s bucket
    lin = Linear(512, d)
    init_torch_defaults(lin, gen)
    lin = quantized(lin)
    x = randn(m, 512)
    run("int8_linear", f"M={m} 512->{d}",
        lambda: Q.int8_linear(x, lin.w_int8, lin.w_scale, lin.bias_f32),
        lambda: Q.int8_linear_plain(x, lin.w_int8, lin.w_scale, lin.bias_f32), None,
        nbytes(x) + m * d * 2 + 512 * d + 8 * d, 2 * m * 512 * d, 0)

    def heads(b, l, h, hd, dtype=torch.bfloat16, generator=None):
        """q/k/v as the routes pass them: head views of a [B, L, H*hd] projection."""
        return randn(b, l, h * hd, dtype=dtype, generator=generator).view(b, l, h, hd) \
            .transpose(1, 2)

    def attn_ops(dtype, b, h, lq, lk, hd):
        """(bf16, fp32, tf32) operations of an attention core at its head dim
        (not the tile's): fp32 runs 3xTF32."""
        ops = 4 * b * h * lq * lk * hd
        if dtype in (torch.bfloat16, torch.float16):
            return ops, 0, 0
        return 0, 0, TF32_PRODUCTS * ops

    # WavLM gated-bias attention core, float trees: the 5 s and 10 s buckets
    # at B=4, 30 s at B=2; fp32: the 10 s bucket at B=4, the long fp32 30 s
    # clips at B=2 and the fp32 extraction batch (8 x 10 s)
    h, hd = 12, 64
    gated_upto = {}
    for bb, l, dt in ((B, 249, torch.bfloat16), (B, 499, torch.bfloat16),
                      (2, 1499, torch.bfloat16), (B, 499, torch.float32),
                      (2, 1499, torch.float32), (8, 499, torch.float32)):
        q, k, v = (heads(bb, l, h, hd, dt) for _ in range(3))
        gate = (torch.rand(bb, h, l, generator=gen) * 1.5 + 0.5).to(dev, dt)
        pos = randn(h, l, l, scale=0.3, dtype=dt)
        kb = torch.where(mask(bb, l), AB.NEG_INF, 0.0).float()
        amask = (gate.float()[..., None] * pos.float()[None] + kb[:, None, None, :]).to(dt)
        run("wavlm_fused_attention", f"B={bb} L={l} {str(dt)[6:]}",
            lambda: WA.wavlm_fused_attention(q, k, v, gate, pos, kb),
            lambda: WA.wavlm_fused_attention_plain(q, k, v, gate, pos, kb),
            lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=amask),
            nbytes(q, k, v, gate, pos, kb, q), 0, *attn_ops(dt, bb, h, l, l, hd),
            tol=ATTN_TOL[dt])
        if (bb, l) == (2, 1499):
            gated_upto[dt] = lambda n, q=q, k=k, v=v, gate=gate, pos=pos, kb=kb: \
                WA.wavlm_fused_attention_plain(q, k[:, :, :n], v[:, :, :n], gate, pos[:, :, :n],
                                               kb[:, :n])
    # after the timings: its large plain versions would move where the fp32
    # row's tensors are allocated, and with them that row's time (PERF.md §6)
    gated_check = {str(dt)[6:]: dropped_tile("wavlm_fused_attention", tile, 1499, dt,
                                             gated_upto[dt])
                   for dt, tile in ((torch.bfloat16, ONEPASS_KEY_TILE),
                                    (torch.float32, TF32_KEY_TILE))}
    del gated_upto

    # fusion audio self-attention, long clips: 30 s (one-pass) and 45 s
    # (streaming), on the bf16 and int8 trees and on the fp32 tree
    h, hd = 8, 96
    limit_check = {}
    for name, l in (("onepass_attention", 1499), ("streaming_attention", 2249)):
        fn, plain = getattr(FA, name), getattr(FA, name + "_plain")
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = (heads(2, l, h, hd, dt) for _ in range(3))
            kpm = mask(2, l)
            bias = FA.key_bias(kpm, 2, l, dev)
            amask = ~kpm[:, None, None, :]
            run(name, f"B=2 {l}x{l} H={h} hd={hd} {str(dt)[6:]}",
                lambda: fn(q, k, v, bias), lambda: plain(q, k, v, bias),
                lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v,
                                                                         attn_mask=amask),
                nbytes(q, k, v, bias, q), 0, *attn_ops(dt, 2, h, l, l, hd), tol=ATTN_TOL[dt])
            if name == "streaming_attention":  # the kernel's key block in each dtype
                limit_check[str(dt)[6:]] = dropped_tile(
                    name, FA.BK if dt == torch.bfloat16 else TF32_KEY_TILE, l, dt,
                    lambda n: plain(q, k[:, :, :n], v[:, :, :n], bias[:, :n]))

    # the same cores on phase 7d's uncapped MOSEI eval: d=256 in 4 heads of
    # 64 (the audio self-attention), each long split's clips padded to the
    # CLI's batch by repeating the last, keys masked at each clip's length;
    # bf16, the eval's compute dtype. Inputs from a generator of their own,
    # so that later rows keep theirs; the limit checks run after the timings.
    own = torch.Generator().manual_seed(SEED + 8)
    h, hd, eb = 4, 64, MEVAL.parse_args(["--ckpt", "unused"]).batch_size
    eval_upto = {}
    for name, split in (("onepass_attention", "long_onepass"),
                        ("streaming_attention", "long_streaming")):
        fn, plain = getattr(FA, name), getattr(FA, name + "_plain")
        la = [a for a, _ in long_lengths(np.random.default_rng(SEED + 7))[split]]
        l, lens = max(la), la + la[-1:] * (eb - len(la))
        q, k, v = (heads(eb, l, h, hd, generator=own) for _ in range(3))
        kpm = (torch.arange(l)[None, :] >= torch.tensor(lens)[:, None]).to(dev)
        bias = FA.key_bias(kpm, eb, l, dev)
        amask = ~kpm[:, None, None, :]
        run(name, f"B={eb} {l}x{l} H={h} hd={hd} bfloat16",
            lambda: fn(q, k, v, bias), lambda: plain(q, k, v, bias),
            lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=amask),
            nbytes(q, k, v, bias, q), 0, *attn_ops(torch.bfloat16, eb, h, l, l, hd),
            tol=ATTN_TOL[torch.bfloat16])
        eval_upto[name] = (l, lambda n, q=q, k=k, v=v, bias=bias, plain=plain:
                           plain(q, k[:, :, :n], v[:, :, :n], bias[:, :n]))

    # float FFN block (off the routed paths): WavLM's widths at the
    # extraction batch (8 x 499 rows), the 10 s serving batch's rows (4 x
    # 499, inputs from a generator of their own so that later rows keep
    # theirs) and a ragged row count, both trees and both GELUs; the route is
    # cuBLAS Linear -> GELU -> Linear -> LayerNorm. fp32 runs 3xTF32.
    d, f = 768, 3072
    own = torch.Generator().manual_seed(SEED + 5)
    for m, dt, fast in [(m, dt, fast) for m in (8 * 499, B * 499, 41)
                        for dt in (torch.bfloat16, torch.float32) for fast in (True, False)]:
        r = lambda *a, **k: randn(*a, **k, generator=own if m == B * 499 else None)
        w1, w2 = r(f, d, scale=0.05, dtype=dt), r(d, f, scale=0.05, dtype=dt)
        b1, b2 = r(f, scale=0.02, dtype=torch.float32), r(d, scale=0.02, dtype=torch.float32)
        g = 1.0 + r(d, scale=0.1, dtype=torch.float32)
        b_ = r(d, scale=0.1, dtype=torch.float32)
        x = r(m, d, dtype=dt)
        b1c, b2c = b1.to(dt), b2.to(dt)
        fp32 = dt == torch.float32
        ops = 4 * m * d * f
        run("ffn_block_bf16", f"M={m} {'tanh' if fast else 'erf'} {str(dt)[6:]}",
            lambda: FF.ffn_block_bf16(x, w1, b1, w2, b2, g, b_, 1e-5, fast),
            lambda: FF.ffn_block_bf16_plain(x, w1, b1, w2, b2, g, b_, 1e-5, fast), None,
            nbytes(x, x, w1, w2, b1, b2, g, b_), 0, 0 if fp32 else ops, 0,
            TF32_PRODUCTS * ops if fp32 else 0, tol=FP32_TOL if fp32 else TOL,
            route=lambda: layer_norm(x + (gelu(x @ w1.t() + b1c, fast) @ w2.t() + b2c), g, b_,
                                     1e-5))
        if m == 8 * 499 and fp32 and fast:
            ffn_grad = ffn_backward_check(x, w1, b1, w2, b2, g, b_)

    # conv stack: each stage on 8 x 10 s (the extraction batch), a 1 s clip
    # at B=1, and 2920 samples (72 conv3 rows, 8 output frames); both trees;
    # the fused stack against the routed feature encoder. The fp32 convs of
    # K1 and K2 run 3xTF32, conv0 (K1's pass and the stats) on CUDA cores.
    # Routes, timed after every other row (late_routes): the Gram-matrix
    # statistics the routed encoder takes, and its cuDNN conv4..6 on the
    # conv3 output in channel-first layout.
    enc = WavLMEncoder(WavLMConfig(num_hidden_layers=1))
    enc.init_weights(gen)
    enc = enc.to(dev).eval()
    enc16 = copy.deepcopy(enc).to(torch.bfloat16)
    edge_inputs, late_routes = {}, []
    for dt in (torch.bfloat16, torch.float32):
        w0, gn_w, gn_b, *taps = CS.stack_operands(enc.feature_extractor, dt)
        tdt = 0 if dt == torch.float32 else 1
        route_enc = enc if dt == torch.float32 else enc16
        route_convs = route_enc.feature_extractor.conv_layers
        for b, tw in ((8, 160000), (1, 16000), (2, 2920)):
            wave = randn(b, tw, scale=0.3, dtype=dt)
            lens = CS.conv_lengths(tw)
            tag = f"B={b} Tw={tw} {str(dt)[6:]}"
            stats = CS.conv_stack_stats_plain(wave, w0)
            x3 = CS.conv_stack_k1_plain(wave, stats, w0, gn_w, gn_b, *taps[:3], EPS, False)
            ops0 = 2 * b * lens[0] * 512 * 10
            ops1 = ops0 + 2 * b * sum(lens[1:4]) * 512 * 512 * 3
            ops2 = 2 * b * (3 * lens[4] + 2 * lens[5] + 2 * lens[6]) * 512 * 512
            conv_ops = lambda n: (0, n * tdt, n * (1 - tdt))
            k1_ops = (*conv_ops(ops1), 0) if tdt else (0, 0, ops0, TF32_PRODUCTS * (ops1 - ops0))
            k2_ops = (*conv_ops(ops2), 0) if tdt else (0, 0, 0, TF32_PRODUCTS * ops2)
            run("conv_stack_stats", tag, lambda: CS.conv_stack_stats(wave, w0),
                lambda: CS.conv_stack_stats_plain(wave, w0), None,
                nbytes(wave, w0, stats), *conv_ops(ops0), tol=STATS_TOL)
            late_routes.append((rows[-1], lambda wave=wave, conv=route_convs[0].conv: lambda:
                                CS.group_norm_stats_from_waveform(wave, conv.weight)))
            run("conv_stack_k1", tag,
                lambda: CS.conv_stack_k1(wave, stats, w0, gn_w, gn_b, *taps[:3], EPS, False),
                lambda: CS.conv_stack_k1_plain(wave, stats, w0, gn_w, gn_b, *taps[:3], EPS,
                                               False), None,
                nbytes(wave, stats, w0, gn_w, gn_b, *taps[:3], x3), *k1_ops, tol=CONV_TOL[dt])
            out = CS.conv_stack_k2_plain(x3, *taps[3:], False)
            run("conv_stack_k2", tag, lambda: CS.conv_stack_k2(x3, *taps[3:], False),
                lambda: CS.conv_stack_k2_plain(x3, *taps[3:], False), None,
                nbytes(x3, *taps[3:], out), *k2_ops, tol=CONV_TOL[dt])
            late_routes.append((rows[-1], functools.partial(k2_route, x3, route_convs[4:7])))
            if b != 8:
                continue
            edge_inputs[dt] = (wave, stats, w0, gn_w, gn_b, taps, x3)
            # the fused stack: fp32 against the cuDNN route (TF32 off) at
            # tests/test_conv_stack.py's 2e-4/2e-3, bf16 against the fp32
            # route at its 0.15 envelope
            with torch.no_grad():
                fused = CS.conv_stack_fused(enc.feature_extractor, wave, enc.config)
                ref = enc._feature_encoder(wave.float())
            tol = (dict(atol=2e-4, rtol=2e-3) if dt == torch.float32 else EXTRACT_ENVELOPE)
            err, _ = compare(f"conv_stack_fused {tag} vs the fp32 route", fused, ref, tol)
            rec = dict(kernel="conv_stack_fused", shape=tag, max_abs_err_vs_fp32_route=err,
                       ms=cuda_ms(lambda: CS.conv_stack_fused(enc.feature_extractor, wave,
                                                              enc.config)),
                       plain_ms=cuda_ms(lambda: CS.conv_stack_fused(
                           enc.feature_extractor, wave, enc.config, use_kernels=False)),
                       route_ms=cuda_ms(lambda: route_enc._feature_encoder(wave)),
                       bound_ms=sum(r["bound_ms"] for r in rows[-3:]))
            rows.append(rec)
            print(f"  conv_stack_fused       {tag:28s} vs fp32 route max|d| {err:.3g}  "
                  f"kernels {rec['ms']:.4f} ms  plain {rec['plain_ms']:.4f} ms  "
                  f"route {rec['route_ms']:.4f} ms", flush=True)
    # after the float and conv rows, so that where their tensors are placed,
    # which moves their times, stays as it was: the int8 sublayers' core
    # alone against SDPA on the same q/k/v, read in
    # place from packed projections as the sublayers pass them (1/sqrt(hd)
    # is in q: scale 1 for both): WavLM gated at the 2.5 s and 10 s buckets,
    # fusion self 499^2, BERT self 64^2 and fusion cross, with padding
    d = 768
    wops = layer.attn_ops
    for h, lq, lk, mode in ((12, 124, 124, "gated"), (12, 499, 499, "gated"),
                            (8, 499, 499, "self"), (12, 64, 64, "self"),
                            (8, 499, 16, "cross"), (8, 16, 499, "cross")):
        hd = d // h
        if mode == "cross":
            q, kv = randn(B * lq, d, scale=hd ** -0.5), randn(B * lk, 2 * d)
            k, v = kv.split(d, dim=1)
        else:
            qkv = randn(B * lq, 3 * d)
            qkv[:, :d] *= hd ** -0.5
            q, k, v = qkv.split(d, dim=1)
        pad = mask(B, lk)
        if mode == "gated":
            kw = dict(kbias=torch.where(pad, AB.NEG_INF, 0.0).float(),
                      gate=(randn(B * lq, d), wops.wg, wops.bg, wops.gconst,
                            randn(h, lq, lk, scale=0.3)))
            x_, *_, pos_ = kw["gate"]
            amask = (AB._gate(*kw["gate"][:4], B, lq, h) * pos_.float()[None]
                     + kw["kbias"][:, None, None, :]).to(torch.bfloat16)
            in_bytes, gate_ops = nbytes(x_, pos_, kw["kbias"]), 2 * B * lq * d * 8
        else:
            kw, amask = dict(kpm=pad), ~pad[:, None, None, :]
            in_bytes, gate_ops = nbytes(pad), 0
        qh, kh, vh = (t.view(B, -1, h, hd).transpose(1, 2) for t in (q, k, v))
        run("attention_core_int8", f"B={B} {mode} {lq}x{lk} H={h}",
            lambda: AB.attention_core_int8(q, k, v, B, h, **kw).view(B, lq, d),
            lambda: AB.attention_core_int8_plain(q, k, v, B, h, **kw).view(B, lq, d),
            lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, attn_mask=amask,
                                                                     scale=1.0),
            nbytes(q, k, v, q) + in_bytes, 0, 4 * B * h * lq * lk * hd, gate_ops,
            tol=ATTN_TOL[torch.bfloat16])
        rows[-1]["counter_key"] = [B, lq, lk, h, hd]
        if mode == "gated" and lq == 499:
            def core_upto(n, q=q, k=k, v=v, kw=kw, h=h):
                cut = lambda t: t.view(B, 499, d)[:, :n].reshape(B * n, d)
                x_, wg_, bg_, gc_, pos_ = kw["gate"]
                return AB.attention_core_int8_plain(
                    q, cut(k), cut(v), B, h, kbias=kw["kbias"][:, :n],
                    gate=(x_, wg_, bg_, gc_, pos_[:, :, :n])).view(B, 499, d)

    # the shared int8 GEMM alone at the 10 s bucket's rows, each (N, K) with
    # the epilogue it has on the path (q/k/v, WavLM out-proj, FFN in and out,
    # feature projection); torch._int_mm (int32 out, no epilogue) on the same
    # int8 operands is the yardstick. The int32 sum is exact: bit-equal.
    m = B * 499
    for n, k, epi in ((2304, 768, _cuda.EPI_BF16), (768, 768, _cuda.EPI_RESID_LAST),
                      (3072, 768, _cuda.EPI_GELU_F32), (768, 3072, _cuda.EPI_RESID_FIRST),
                      (768, 512, _cuda.EPI_BF16)):
        a = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8).to(dev)
        w = torch.randint(-127, 128, (n, k), generator=gen, dtype=torch.int8).to(dev)
        a_s = (torch.rand(m, generator=gen) * 1e-2 + 1e-4).to(dev)
        w_s = (torch.rand(n, 1, generator=gen) * 1e-3 + 1e-5).to(dev)
        bias = randn(n, dtype=torch.float32)
        resid = randn(m, n) if epi in (_cuda.EPI_RESID_FIRST, _cuda.EPI_RESID_LAST) else None
        run("int8_gemm", f"M={m} N={n} K={k} epi={epi}",
            lambda: _cuda.int8_gemm(a, a_s, w, w_s, bias, epi, resid=resid),
            lambda: FF.int8_gemm_plain(a, a_s, w, w_s, bias, epi, resid),
            lambda: torch._int_mm(a, w.t()),
            nbytes(a, w, a_s, w_s, bias, resid) + m * n * (2 if epi == _cuda.EPI_BF16 else 4),
            2 * m * n * k, 0, tol=dict(atol=0.0, rtol=0.0))
        rows[-1]["counter_key"] = [m, n, k]
        # each block configuration forced, beside the one chosen by shape
        rows[-1]["config_ms"] = {name: cuda_ms(lambda c=c: _cuda.int8_gemm(
            a, a_s, w, w_s, bias, epi, resid=resid, config=c))
            for c, name in enumerate(_cuda.GEMM_CONFIGS)}
        print(f"    by configuration: {rows[-1]['config_ms']}", flush=True)

    # fp16 on the flash route (and the gated WavLM core, the same launch):
    # the one-pass and streaming cores at phase 7d's shapes (B=16, 4 heads of
    # 64, keys masked at each clip's length) and at the long clips' 8 x 96,
    # SDPA in fp16 beside each; then the head dims beside 64 and 96 at phase
    # 7d's shapes: the MOSEI model's d=256 in 8 heads (hd 32) in bf16, fp16
    # and fp32, 2 heads of 128 in bf16 and fp32, and 8 heads of 40 (run on
    # the hd-64 instance, zero-padded) in bf16, each beside the CUDA-core
    # kernel that served it before (``cuda_cores=True``) and SDPA. Inputs
    # from a generator of their own, after every earlier row, so that those
    # keep their inputs; none of these rows feeds the kernels line.
    own = torch.Generator().manual_seed(SEED + 9)
    flash_upto, first_new = {}, len(rows)
    h, hd = 12, 64
    q, k, v = (heads(2, 1499, h, hd, torch.float16, own) for _ in range(3))
    gate = (torch.rand(2, h, 1499, generator=own) * 1.5 + 0.5).to(dev, torch.float16)
    pos = randn(h, 1499, 1499, scale=0.3, dtype=torch.float16, generator=own)
    kb = torch.where(mask(2, 1499, own), AB.NEG_INF, 0.0).float()
    amask = (gate.float()[..., None] * pos.float()[None] + kb[:, None, None, :]).half()
    run("wavlm_fused_attention", "B=2 L=1499 float16",
        lambda: WA.wavlm_fused_attention(q, k, v, gate, pos, kb),
        lambda: WA.wavlm_fused_attention_plain(q, k, v, gate, pos, kb),
        lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=amask),
        nbytes(q, k, v, gate, pos, kb, q), 0, *attn_ops(torch.float16, 2, h, 1499, 1499, hd),
        tol=ATTN_TOL[torch.float16])
    flash_upto["wavlm_fused_attention float16"] = (
        1499, ONEPASS_KEY_TILE, torch.float16,
        lambda n, q=q, k=k, v=v, gate=gate, pos=pos, kb=kb: WA.wavlm_fused_attention_plain(
            q, k[:, :, :n], v[:, :, :n], gate, pos[:, :, :n], kb[:, :n]))
    lens7d = {split: [a for a, _ in long_lengths(np.random.default_rng(SEED + 7))[split]]
              for split in LONG_MOSEI}
    def flash_row(name, bb, l, h, hd, lens, dt, generator, faster=False):
        """One flash-core row (keys masked at ``lens``, or at random
        lengths), with, off head dims 64 and 96, the instance that ran and
        the CUDA-core kernel that served it before (``faster``: the row
        must beat it); its limit check goes to ``flash_upto``."""
        fn, plain = getattr(FA, name), getattr(FA, name + "_plain")
        parent = WA.onepass_launch if name == "onepass_attention" else FA.streaming_launch
        q, k, v = (heads(bb, l, h, hd, dt, generator) for _ in range(3))
        kpm = (mask(bb, l, generator) if lens is None else
               (torch.arange(l)[None, :] >= torch.tensor(lens)[:, None]).to(dev))
        bias = FA.key_bias(kpm, bb, l, dev)
        amask = ~kpm[:, None, None, :]
        shape = f"B={bb} {l}x{l} H={h} hd={hd} {str(dt)[6:]}"
        got, ref = run(name, shape, lambda: fn(q, k, v, bias), lambda: plain(q, k, v, bias),
                       lambda: torch.nn.functional.scaled_dot_product_attention(
                           q, k, v, attn_mask=amask),
                       nbytes(q, k, v, bias, q), 0, *attn_ops(dt, bb, h, l, l, hd),
                       tol=ATTN_TOL[dt])
        if hd not in (64, 96):
            rows[-1].update(tile_instance(name, hd, lambda: fn(q, k, v, bias), dt))
            err, _ = compare(f"{name} {shape} on CUDA cores",
                             parent(q, k, v, bias, cuda_cores=True), ref, ATTN_TOL[dt])
            rows[-1]["parent_ms"] = cuda_ms(lambda: parent(q, k, v, bias, cuda_cores=True))
            print(f"    on {rows[-1]['kernel_name']} (instance hd {rows[-1]['instance']}); "
                  f"parent (CUDA cores) {rows[-1]['parent_ms']:.4f} ms, max|d| {err:.3g}; "
                  f"kernel {rows[-1]['ms']:.4f} ms; SDPA {rows[-1]['library_ms']:.4f} ms",
                  flush=True)
            if faster and not rows[-1]["ms"] < rows[-1]["parent_ms"]:
                raise AssertionError(f"{name} {shape}: {rows[-1]['ms']:.4f} ms on the tile "
                                     f"instance, {rows[-1]['parent_ms']:.4f} on CUDA cores")
        del got, ref
        tile = (TF32_KEY_TILE if dt == torch.float32 else
                ONEPASS_KEY_TILE if name == "onepass_attention" else FA.BK)
        flash_upto[f"{name} {h}x{hd} {str(dt)[6:]}"] = (
            l, tile, dt, lambda n, q=q, k=k, v=v, bias=bias, plain=plain:
            plain(q, k[:, :, :n], v[:, :, :n], bias[:, :n]))

    for name, split, long_l in (("onepass_attention", "long_onepass", 1499),
                                ("streaming_attention", "long_streaming", 2249)):
        la = lens7d[split]
        lens = la + la[-1:] * (eb - len(la))
        cases = [(eb, max(la), 4, 64, lens, torch.float16),
                 (2, long_l, 8, 96, None, torch.float16)]
        cases += [(eb, max(la), h, hd, lens, dt)
                  for h, hd, dts in ((8, 32, (torch.bfloat16, torch.float16, torch.float32)),
                                     (2, 128, (torch.bfloat16, torch.float32)),
                                     (8, 40, (torch.bfloat16,)))
                  for dt in dts]
        for case in cases:
            flash_row(name, *case, own)
    # the wide tiles (HD 192 and 256), bf16 and fp16, then fp32 (the CLIs at
    # --compute_dtype float32 / --amp_dtype off), SDPA in the row's dtype
    # beside each: the MOSEI model at --n_heads 1 (d=256 in one head of 256)
    # at phase 7d's uncapped shapes, and the IEMOCAP decoder at d=768 in 4
    # heads of 192 at the long clips' lengths; each must beat the CUDA-core
    # kernel it replaces. Inputs from a generator of their own per dtype
    # group, after every earlier row.
    first_wide = len(rows)
    for seed, dts in ((SEED + 11, (torch.bfloat16, torch.float16)),
                      (SEED + 14, (torch.float32,))):
        own = torch.Generator().manual_seed(seed)
        for name, split, long_l in (("onepass_attention", "long_onepass", 1499),
                                    ("streaming_attention", "long_streaming", 2249)):
            la = lens7d[split]
            lens = la + la[-1:] * (eb - len(la))
            for bb, l, h, hd, ll_ in ((eb, max(la), 1, 256, lens), (2, long_l, 4, 192, None)):
                for dt in dts:
                    flash_row(name, bb, l, h, hd, ll_, dt, own, faster=True)
    for r in rows[first_wide:]:
        r["wide_entry"] = f"{r['kernel']} (wide tiles)"
    # the int8 core alone at the head dims beside 64 and 96, on the tile
    # instances (32; 128; 192 on the wide one): B=4 self 499^2 (the 10 s
    # bucket) at d=256 in 8 heads and d=768 in 6 and 4, against SDPA; the
    # CUDA-core kernel that served them before is the parent tree's
    # (hriemo_torch/utils/phase3_ab.py)
    own = torch.Generator().manual_seed(SEED + 12)
    for d_, h in ((256, 8), (768, 6), (768, 4)):
        hd = d_ // h
        qkv = randn(B * 499, 3 * d_, generator=own)
        qkv[:, :d_] *= hd ** -0.5
        q, k, v = qkv.split(d_, dim=1)
        pad = mask(B, 499, own)
        qh, kh, vh = (t.view(B, -1, h, hd).transpose(1, 2) for t in (q, k, v))
        amask = ~pad[:, None, None, :]
        run("attention_core_int8", f"B={B} self 499x499 H={h} hd={hd}",
            lambda: AB.attention_core_int8(q, k, v, B, h, kpm=pad).view(B, 499, d_),
            lambda: AB.attention_core_int8_plain(q, k, v, B, h, kpm=pad).view(B, 499, d_),
            lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, attn_mask=amask,
                                                                     scale=1.0),
            nbytes(q, k, v, q, pad), 0, 4 * B * h * 499 * 499 * hd,
            tol=ATTN_TOL[torch.bfloat16])
        rows[-1].update(tile_instance("attention_core_int8", hd, lambda: AB.attention_core_int8(
            q, k, v, B, h, kpm=pad)))
        print(f"    on {rows[-1]['kernel_name']} (instance hd {rows[-1]['instance']})",
              flush=True)
        if hd > 128:
            rows[-1]["wide_entry"] = "attention_core_int8 (wide tiles)"
            cut = lambda t, n, d_=d_: t.view(B, 499, d_)[:, :n].reshape(B * n, d_)
            flash_upto[f"attention_core_int8 {h}x{hd} bfloat16"] = (
                499, ONEPASS_KEY_TILE, torch.bfloat16,
                lambda n, q=q, k=k, v=v, pad=pad, h=h, d_=d_, cut=cut:
                AB.attention_core_int8_plain(q, cut(k, n), cut(v, n), B, h,
                                             kpm=pad[:, :n]).view(B, 499, d_))
    for r in rows[first_new:]:
        r["kernels_line"] = False

    # the conv stack's routes, after the other timings
    for rec, make_route in late_routes:
        rec["route_ms"] = cuda_ms(make_route())
        print(f"  {rec['kernel']:22s} {rec['shape']:28s} route {rec['route_ms']:.4f} ms "
              f"(kernel {rec['ms']:.4f} ms)", flush=True)
    del late_routes
    # the int8 core without its last key tile, K1 and K2 without one
    # tile-edge row's third tap, the stats without their last chunk and
    # twice on the same input, after every timing
    core_check = dropped_tile("attention_core_int8", ONEPASS_KEY_TILE, 499, torch.bfloat16,
                              core_upto)
    eval_check = {name: dropped_tile(f"{name} hd=64", tile, eval_upto[name][0],
                                     torch.bfloat16, eval_upto[name][1])
                  for name, tile in (("onepass_attention", ONEPASS_KEY_TILE),
                                     ("streaming_attention", FA.BK))}
    del eval_upto
    flash_check = {name: dropped_tile(name, tile, lk, dt, upto)
                   for name, (lk, tile, dt, upto) in flash_upto.items()}
    del flash_upto
    edge_check, k2_edge_check, chunk_check, stats_bits = {}, {}, {}, {}
    for dt, (wave, stats, w0, gn_w, gn_b, taps, x3) in edge_inputs.items():
        name = str(dt)[6:]
        x0 = CS._conv0_gn(wave[:1], stats[:1], w0, gn_w, gn_b, EPS, False)
        edge_check[name] = dropped_tap("conv_stack_k1", "conv1", x0, taps[:3])
        k2_edge_check[name] = dropped_tap("conv_stack_k2", "conv4", x3[:1], taps[3:])
        chunk_check[name] = dropped_chunk(wave, w0)
        stats_bits[name] = same_bits(wave, w0)
    return rows, dict(streaming_last_block=limit_check, onepass_gated_last_tile=gated_check,
                      int8_core_last_tile=core_check, mosei_eval_last_tile=eval_check,
                      flash_last_tile=flash_check,
                      conv_k1_tile_edge=edge_check,
                      conv_k2_tile_edge=k2_edge_check, stats_last_chunk=chunk_check,
                      stats_same_bits=stats_bits, ffn_backward=ffn_grad)


def ffn_backward_check(x, w1, b1, w2, b2, g, b):
    """ffn_block_bf16's gradients of x and W1 (kernel forward, backward
    through the unfused reference) against autograd through the plain
    path, at tests/test_fused_ffn.py's 1e-3 (the upstream gradients differ
    by the forwards' difference, and W1's sums over M rows); returns the
    max |error| of each."""
    grads = []
    for fn in (FF.ffn_block_bf16, FF.ffn_reference):
        xi, wi = x.clone().requires_grad_(True), w1.clone().requires_grad_(True)
        (fn(xi, wi, b1, w2, b2, g, b, 1e-5, True) ** 2).sum().backward()
        grads.append((xi.grad, wi.grad))
    out = {}
    for name, got, ref in zip(("x", "w1"), *grads):
        out[name], _ = compare(f"ffn_block_bf16 gradient of {name}", got, ref,
                               dict(atol=1e-3, rtol=1e-3))
    print(f"  ffn_block_bf16 backward M={x.shape[0]} float32: max|d| x {out['x']:.3g}, "
          f"W1 {out['w1']:.3g}", flush=True)
    return out


def k2_route(x3, convs):
    """K2's function on the routed encoder's path, as a call of no
    arguments: its cuDNN conv4..6 with erf GELU over ``x3 [B, t3, C]`` in
    channel-first layout (made here, outside the call)."""
    x3_cf = x3.transpose(1, 2).contiguous()

    def route():
        with torch.no_grad():
            x = x3_cf
            for layer in convs:
                x = gelu(layer.conv(x), False)
            return x
    return route


def dropped_tap(kernel, conv, x, taps, row=127):
    """``CONV_TOL`` must reject a result of ``kernel`` (its convs ``taps``
    over ``x``, batch element 0) whose first conv's row ``row`` (127: the
    last row of the first 128-row GEMM tile) sums only two of its three
    taps, as a K-loop that stopped a tap early at the tile's edge would; the
    later convs then run on it as they are. Returns that wrong result's max
    and median |error|."""
    first = CS._conv_s2(x, taps[0], False)
    cut = first.clone()
    two = sum(x[:, 2 * row + k].float() @ taps[0][k].float().t() for k in range(2))
    cut[:, row] = FF.gelu_fp32(two, False).to(x.dtype)
    ref, wrong = first, cut
    for t in taps[1:]:
        ref, wrong = CS._conv_s2(ref, t, False), CS._conv_s2(wrong, t, False)
    diff = (wrong.float() - ref.float()).abs()
    reading = dict(row=f"{conv} row {row} of batch element 0 without tap 2",
                   max_abs_err=diff.max().item(),
                   median_abs_err_per_batch=diff.flatten(1).median(dim=1).values.tolist())
    try:
        compare(f"{kernel} {str(x.dtype)[6:]} with a tile-edge row's third tap dropped",
                wrong, ref, CONV_TOL[x.dtype])
    except AssertionError as e:
        print(f"  limit check: rejected, as it must be: {e}", flush=True)
        return reading
    raise AssertionError(f"CONV_TOL passes a {kernel} result without a tile-edge row's third "
                         f"tap: {reading}")


def dropped_chunk(wave, w0):
    """``STATS_TOL`` must reject GroupNorm sums without the last, partial
    chunk of ``CS.STATS_ROWS`` conv0 rows, as a second level that stopped a
    chunk early would give. Returns that wrong result's max |error|."""
    n0 = CS.conv_lengths(wave.shape[1])[0]
    kept = (n0 - 1) // CS.STATS_ROWS * CS.STATS_ROWS
    x0 = CS._conv0(wave, w0)[:, :kept]
    wrong = torch.stack([x0.sum(dim=1), (x0 * x0).sum(dim=1)], dim=1)
    ref = CS.conv_stack_stats_plain(wave, w0)
    reading = dict(rows=f"{kept} of {n0}", max_abs_err=(wrong - ref).abs().max().item())
    try:
        compare(f"conv_stack_stats {str(wave.dtype)[6:]} without its last chunk", wrong, ref,
                STATS_TOL)
    except AssertionError as e:
        print(f"  limit check: rejected, as it must be: {e}", flush=True)
        return reading
    raise AssertionError(f"STATS_TOL passes GroupNorm sums without their last chunk: {reading}")


def same_bits(wave, w0):
    """The stats kernel adds its chunks in a fixed order: two calls on the
    same input must give the same bits. Returns True."""
    first, second = CS.conv_stack_stats(wave, w0), CS.conv_stack_stats(wave, w0)
    torch.cuda.synchronize()
    if not torch.equal(first, second):
        raise AssertionError(f"conv_stack_stats {str(wave.dtype)[6:]}: two calls differ, max "
                             f"|d| {(first - second).abs().max().item():.4g}")
    print(f"  conv_stack_stats {str(wave.dtype)[6:]}: the same bits on two calls", flush=True)
    return True


# the attention cores' kernels by their names in the source: the tile
# instances, and the CUDA-core kernels that the head dims on the tiles must
# no longer reach
TILE_KERNELS = {"onepass_attention": ("onepass_mma_kernel", "onepass_wide_kernel",
                                      "attn_tf32_kernel", "attn_tf32_wide_kernel"),
                "streaming_attention": ("streaming_mma_kernel", "streaming_wide_kernel",
                                        "attn_tf32_kernel", "attn_tf32_wide_kernel"),
                "attention_core_int8": ("onepass_mma_kernel", "onepass_wide_kernel")}
CUDA_CORE_KERNELS = ("onepass_attn_kernel", "streaming_attn_kernel", "attn_core_kernel")
# the library that launches each core's kernels
CORE_LIBS = {"onepass_attention": "wavlm_attention", "streaming_attention": "flash_attention",
             "attention_core_int8": "attention"}


def tile_instance(name, hd, fn, dtype=torch.bfloat16) -> dict:
    """The instance that the C dispatch names for ``hd`` in ``dtype`` and
    the kernel that one call of ``fn`` launched, as its library records it
    where it launches (``_cuda.last_kernel``): it must be a tile kernel of
    ``name``'s at that instance, and not a CUDA-core one. torch.profiler
    traces the same call: where the trace holds the device's kernels (the
    card's profiler has returned none now and then), it must show that
    kernel and no other attention kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    code = _cuda.DTYPE_CODES[dtype]
    instance = (_cuda.lib("flash_attention").hr_streaming_instance(hd, code)
                if name == "streaming_attention"
                else _cuda.lib("wavlm_attention").hr_onepass_instance(hd, 0, code))
    _cuda.last_kernel(CORE_LIBS[name])  # clears the record
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernel, kernel_hd = _cuda.last_kernel(CORE_LIBS[name])
    names = [e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if instance == 0 or kernel not in TILE_KERNELS[name] or kernel_hd != instance:
        raise AssertionError(f"{name} at head dim {hd}: instance {instance}, launched "
                             f"{kernel} at {kernel_hd}: not a tile kernel of "
                             f"{TILE_KERNELS[name]} at the instance")
    traced = [n for n in names if any(t in n for t in TILE_KERNELS[name] + CUDA_CORE_KERNELS)]
    if not names:
        print(f"    {name} at head dim {hd}: the trace recorded no device kernel; "
              f"read the launch record alone", flush=True)
    elif len(traced) != 1 or f"{kernel}<" not in traced[0]:
        raise AssertionError(f"{name} at head dim {hd}: launched {kernel}, the trace shows "
                             f"{names}")
    return dict(instance=instance, kernel_name=traced[0] if traced else f"{kernel}<{kernel_hd}>")


def dropped_tile(name, tile, lk, dtype, plain_upto):
    """``ATTN_TOL`` must reject a result that skips the last, partial key
    tile of ``tile`` keys: ``plain_upto(n)`` is the plain version over the
    first ``n`` keys. Only rows whose last keys are valid (batch element 0)
    move. Returns that wrong result's max and median |error|."""
    ref = plain_upto(lk)
    lt = lk // tile * tile
    wrong = plain_upto(lt)
    diff = (wrong.float() - ref.float()).abs()
    reading = dict(keys=f"{lt} of {lk}", max_abs_err=diff.max().item(),
                   median_abs_err_per_batch=diff.flatten(1).median(dim=1).values.tolist())
    try:
        compare(f"{name} without its last key tile", wrong, ref, ATTN_TOL[dtype])
    except AssertionError as e:
        print(f"  limit check: rejected, as it must be: {e}", flush=True)
        return reading
    raise AssertionError(f"ATTN_TOL passes a {name} result without its last key tile: "
                         f"{reading}")


def serving_models(gen):
    wavlm = WavLMEncoder(WavLMConfig(fast_gelu=True))
    wavlm.init_weights(gen)
    bert = BertEncoder(BertConfig(fast_gelu=True))
    bert.init_weights(gen)
    fusion = FusionWithEmotionDecoder(d_model=768, num_emotions=4, n_heads=8,
                                      num_layers_fusion=2, num_layers_decoder=2,
                                      beta_hidden=256)
    fusion.init_weights(gen)
    return wavlm, bert, fusion


def requests(rng, n: int = 16):
    """int16 PCM clips, half in the 2.5 s bucket and half in the 10 s one,
    with texts at ~150 words/min (bench.py:150-172)."""
    words = np.array("happy sad angry neutral really very today fine so not".split())
    out = []
    for i in range(n):
        sec = rng.uniform(1.5, 2.5) if i % 2 == 0 else rng.uniform(7.6, 10.0)
        nw = int(rng.integers(11, 14)) if i % 2 == 0 else int(rng.integers(40, 56))
        pcm = (rng.standard_normal(int(sec * 16000)) * 3000).astype(np.int16)
        out.append((pcm, " ".join(rng.choice(words, nw)), f"u{i}"))
    return out


def long_requests(rng):
    """Two clips of 28-30 s (the 30 s bucket, 1499 WavLM frames) and two of
    42-45 s (the 45 s bucket, 2249 frames), texts at ~150 words/min."""
    words = np.array("happy sad angry neutral really very today fine so not".split())
    out = []
    for i, (lo, hi) in enumerate(((28.0, 30.0), (28.0, 30.0), (42.0, 45.0), (42.0, 45.0))):
        sec = rng.uniform(lo, hi)
        pcm = (rng.standard_normal(int(sec * 16000)) * 3000).astype(np.int16)
        out.append((pcm, " ".join(rng.choice(words, int(sec * 2.5))), f"long{i}"))
    return out


def reset_launches():
    for fn, _, _ in KERNELS.values():
        fn.launches = 0
    for fn in COUNTED_BY_SHAPE:
        fn.launches = 0
        fn.shapes.clear()
    for fn in COUNTED_BY_HEAD_DIM:
        fn.head_dims.clear()


def read_launches():
    out = {name: fn.launches for name, (fn, _, _) in KERNELS.items()}
    for fn in COUNTED_BY_HEAD_DIM:
        out[f"{fn.__name__} (wide tiles)"] = sum(
            n for (hd, _), n in fn.head_dims.items() if hd > 128)
    out["attention_core_int8 (wide tiles)"] = sum(
        n for key, n in AB.attention_core_int8.shapes.items() if key[-1] > 128)
    return out


def check_launches(what, got, want):
    """``want`` maps kernel name -> launches; every other kernel of ``got``
    must be 0."""
    for name in got:
        if got[name] != want.get(name, 0):
            raise AssertionError(f"{what}: {name} launched {got[name]} times, "
                                 f"want {want.get(name, 0)}")


def prob_delta(a, b, clips):
    return float(np.max(np.abs(np.stack([a[c[2]][0] for c in clips])
                               - np.stack([b[c[2]][0] for c in clips]))))


def check_probs(what, got, clips):
    probs = np.stack([got[c[2]][0] for c in clips])
    if probs.shape != (len(clips), 4) or not np.isfinite(probs).all() \
            or probs.min() < 0 or probs.max() > 1 or np.abs(probs.sum(1) - 1).max() > 1e-3:
        raise AssertionError(f"{what}: bad probabilities: {probs}")


def serve(pipe, clips, batch: int = B):
    res = {}
    t = time.perf_counter()
    for probs, beta, uids in pipe.stream_bucketed(clips, bucket_batch={}, default_batch=batch):
        for u, p, b in zip(uids, probs, beta):
            res[u] = (p, b)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t


def profile(pipe, clips, tag: str, batch: int = B) -> None:
    """``--profile``: torch.profiler over one serving pass."""
    profile_call(tag, lambda: serve(pipe, clips, batch)[1])


def profile_call(tag: str, fn) -> None:
    """``--profile``: torch.profiler over ``fn()``, which returns its wall
    seconds; device busy share and device time by kernel name go to
    chip_smoke_out/profile_<tag>.txt."""
    if "--profile" not in sys.argv[1:]:
        return
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        secs = fn()
    events = prof.key_averages()
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    lines = [f"wall {secs * 1e3:.3f} ms (profiled), device busy {busy_ms:.3f} ms "
             f"({busy_ms / (secs * 1e3):.1%})"]
    lines += [f"{e.self_device_time_total / 1e3:10.3f} ms {e.count:6d}x  {e.key[:100]}"
              for e in kernels]
    (OUT / f"profile_{tag}.txt").write_text(
        "\n".join(lines) + "\n\n" + events.table(sort_by="cpu_time_total", row_limit=30))
    print(f"profile {tag}:", "\n  ".join(lines[:12]), flush=True)


def fake_iemocap(root: pathlib.Path, rng, sessions=(1, 4, 5), per_session=9):
    """A synthetic IEMOCAP tree in tests/test_dataprep.py::make_fake_iemocap's
    layout: per session one dialog of ``per_session`` utterances of 1.5-12 s
    (every third at 44.1 kHz stereo), transcripts at ~150 words/min, and
    one 'oth' label per session, which the index drops."""
    from scipy.io import wavfile

    labels = ["ang", "hap", "sad", "neu", "fru", "exc"]
    words = np.array("happy sad angry neutral really very today fine so not".split())
    for s in sessions:
        sess = root / f"Session{s}"
        dialog = f"Ses0{s}F_impro01"
        dirs = {k: sess / p for k, p in (("emo", "dialog/EmoEvaluation"),
                                          ("tr", "dialog/transcriptions"),
                                          ("wav", f"sentences/wav/{dialog}"))}
        for d in dirs.values():
            d.mkdir(parents=True)
        emo_lines, tr_lines = ["% header"], []
        for i in range(per_session):
            uid = f"{dialog}_F{i:03d}"
            sec = rng.uniform(1.5, 12.0)
            lab = "oth" if i == per_session - 1 else labels[(s + i) % len(labels)]
            emo_lines.append(f"[{2 * i:.4f} - {2 * i + sec:.4f}]\t{uid}\t{lab}\t[2.5, 2.5, 2.5]")
            sr, shape = (44100, (int(sec * 44100), 2)) if i % 3 == 0 else (16000, (int(sec * 16000),))
            wavfile.write(dirs["wav"] / f"{uid}.wav", sr,
                          (rng.standard_normal(shape) * 3000).astype(np.int16))
            text = " ".join(rng.choice(words, max(1, int(sec * 2.5))))
            tr_lines.append(f"{uid} [{2 * i:.4f}-{2 * i + sec:.4f}]: {text}")
        (dirs["emo"] / f"{dialog}.txt").write_text("\n".join(emo_lines))
        (dirs["tr"] / f"{dialog}.txt").write_text("\n".join(tr_lines))


def compare_features(what, got_dir, ref_dir, uids, tol):
    """Seq-level feature files of ``uids`` in two directories: the same
    masks and finite hidden states within ``tol``: ``atol``/``rtol`` per
    element (and ``median``, per utterance), or ``rel``, a limit on max |d|
    / max |ref| per utterance. Returns the reading: max |d|, the largest
    per-utterance median and relative max, and the share of elements
    outside TOL's atol/rtol."""
    reading = dict(max_abs_err=0.0, max_median=0.0, max_rel=0.0, outside_tol=0, elements=0)
    fails = []
    for uid in uids:
        (got, gm), (ref, rm) = (load_feature(d / f"{uid}.npz") for d in (got_dir, ref_dir))
        if not np.array_equal(gm, rm) or got.shape != ref.shape or not np.isfinite(got).all():
            raise AssertionError(f"{what} {uid}: mask, shape or non-finite values differ")
        d = np.abs(got - ref)
        med, rel = float(np.median(d)), float(d.max() / np.abs(ref).max())
        reading["max_abs_err"] = max(reading["max_abs_err"], float(d.max()))
        reading["max_median"] = max(reading["max_median"], med)
        reading["max_rel"] = max(reading["max_rel"], rel)
        reading["outside_tol"] += int((d > TOL["atol"] + TOL["rtol"] * np.abs(ref)).sum())
        reading["elements"] += d.size
        bad = rel > tol["rel"] if "rel" in tol else \
            (d > tol["atol"] + tol["rtol"] * np.abs(ref)).any() or med >= tol.get("median", 1.0)
        if bad:
            fails.append(uid)
    print(f"  {what}: {reading} (limit {tol})", flush=True)
    if fails:
        raise AssertionError(f"{what}: {len(fails)} utterances outside {tol}: {fails[:4]}")
    return reading


def extraction(gen, smi: str, root: pathlib.Path):
    """Phase 5, in ``root``. Returns its record, the launches of its
    main-path runs, and the index and the two encoders, which phase 7
    reuses."""
    root.mkdir()
    fake_iemocap(root / "IEMOCAP", np.random.default_rng(SEED + 2))
    idx = II.main(["--base", str(root / "IEMOCAP"), "--out_dir", str(root / "data")])
    rows = II.read_csv(idx)
    if len(rows) != 24:
        raise AssertionError(f"index: {len(rows)} rows, want 24")
    wavlm = WavLMEncoder(WavLMConfig.base_plus())
    wavlm.init_weights(gen)
    bert = BertEncoder(BertConfig.base_uncased())
    bert.init_weights(gen)

    def args(modality, dtype, level="seq"):
        return EX.parse_args(["--modality", modality, "--level", level, "--index_csv", str(idx),
                              "--out_dir", "unused", "--random_init", "--batch_size", "8",
                              "--max_seconds", "10", "--max_len_text", "128",
                              "--compute_dtype", dtype])

    def out(name):
        d = root / name
        d.mkdir()
        return d

    rec, total = {}, dict.fromkeys(LAUNCH_NAMES, 0)
    uids = [r["utter_id"] for r in rows]
    for dtype in ("float32", "bfloat16"):
        EX.extract_audio(args("audio", dtype), rows[:8], out(f"warm_{dtype}"), model=wavlm)
        for level in ("seq", "utter"):
            reset_launches()
            st = EX.extract_audio(args("audio", dtype, level), rows, out(f"audio_{level}_{dtype}"),
                                  model=wavlm)
            ll = read_launches()
            check_launches(f"extract audio {level} {dtype}", ll,
                           {n: k * st["forwards"] for n, k in PER_FORWARD_EXTRACT.items()})
            for name, n in ll.items():
                total[name] += n
            rec[f"audio_{level}_{dtype}"] = dict(st, utt_per_s=st["count"] / st["seconds"],
                                                 launches=ll)
            print(f"extract audio {level} {dtype}: {st['count']} utterances in "
                  f"{st['forwards']} forwards, {st['seconds']:.3f} s, "
                  f"{st['count'] / st['seconds']:.2f} utt/s at B=8 ({smi}); launches {ll}",
                  flush=True)
        profile_call(f"extract_{dtype}", lambda: EX.extract_audio(
            args("audio", dtype), rows, out(f"profile_{dtype}"), model=wavlm)["seconds"])
        st = EX.extract_audio(args("audio", dtype), rows, out(f"plain_{dtype}"), model=wavlm,
                              use_kernels=False)
        rec[f"kernels_vs_plain_{dtype}"] = dict(
            compare_features(f"extract {dtype} kernels vs plain", root / f"audio_seq_{dtype}",
                             root / f"plain_{dtype}", uids, FEATURE_TOL[dtype]),
            plain_seconds=st["seconds"])

    st = EX.extract_text(args("text", "float32"), rows, out("text_seq"), model=bert)
    rec["text_seq_float32"] = dict(st, utt_per_s=st["count"] / st["seconds"])
    report = check_integrity(str(idx), str(root / "audio_seq_float32"), str(root / "text_seq"))
    print(f"extract text: {st['count']} utterances in {st['seconds']:.3f} s; integrity "
          f"{report}", flush=True)
    if not report["ok"] or report["csv_missing_audio"] or report["csv_missing_text"]:
        raise AssertionError(f"check_integrity: {report}")
    rec["integrity"] = report

    # forced gates: the fused conv stack and the float FFN block on one batch
    gates = (CS.use_conv_stack, FF.use_ffn_bf16)
    CS.use_conv_stack, FF.use_ffn_bf16 = (lambda *a: True), (lambda *a: True)
    try:
        for dtype in ("float32", "bfloat16"):
            reset_launches()
            st = EX.extract_audio(args("audio", dtype), rows[:8], out(f"forced_{dtype}"),
                                  model=wavlm)
            ll = read_launches()
            check_launches(f"forced gates {dtype}", ll,
                           {n: k * st["forwards"] for n, k in PER_FORWARD_FORCED.items()})
            for name, n in ll.items():
                total[name] += n
            print(f"forced gates {dtype}: launches {ll}", flush=True)
            tol = dict(rel=2e-3) if dtype == "float32" else EXTRACT_ENVELOPE
            rec[f"forced_{dtype}"] = dict(st, launches=ll, vs_routed=compare_features(
                f"forced gates {dtype} vs routed", root / f"forced_{dtype}",
                root / f"audio_seq_{dtype}", uids[:8], tol))
    finally:
        CS.use_conv_stack, FF.use_ffn_bf16 = gates
    return rec, total, (idx, wavlm, bert)


def timed_steps(record, tag=None):
    """Wrap ``TS.make_train_step`` so that each step of a trainer is timed:
    the host clock between two synchronisations (wall) and CUDA events.
    ``record`` gets ``(wall_ms, start_event, end_event, metrics)`` per step.
    With ``--profile`` and a ``tag``, the second step is traced instead and
    recorded without times."""
    def make_timed(model, cfg, mesh=None):
        step = _MAKE_TRAIN_STEP(model, cfg, mesh)
        traced = []

        def timed(state, batch, generator=None):
            if tag and len(record) == 1 and not traced and "--profile" in sys.argv[1:]:
                profile_call(tag, lambda: timed_wall(
                    lambda: traced.append(step(state, batch, generator))))
                record.append((None, None, None, traced[0][1]))
                return traced[0]
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t = time.perf_counter()
            e0.record()
            state, metrics = step(state, batch, generator)
            e1.record()
            torch.cuda.synchronize()
            record.append(((time.perf_counter() - t) * 1e3, e0, e1, metrics))
            return state, metrics
        return timed
    return make_timed


def step_stats(record):
    """Per-step readings of a trainer run: wall and event ms (the median
    without the first step, which meets cold caches), steps per second over
    all steps, and the step's metrics as floats."""
    timed = [r for r in record if r[0] is not None]
    wall = [r[0] for r in timed]
    ev = [r[1].elapsed_time(r[2]) for r in timed]
    metrics = [{k: float(v) for k, v in r[3].items()} for r in record]
    rest = slice(1, None) if len(timed) > 1 else slice(None)
    return dict(steps=len(record), wall_ms=wall, event_ms=ev,
                median_wall_ms=float(np.median(wall[rest])),
                median_event_ms=float(np.median(ev[rest])),
                steps_per_s=len(timed) / (sum(wall) / 1e3), metrics=metrics)


def run_trainer(cli, argv, tag):
    """One trainer's ``main(argv)`` with its steps timed. Returns its result,
    the step readings, peak device memory and the launches of the run."""
    record = []
    TS.make_train_step = timed_steps(record, tag)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    try:
        best = cli.main(argv)
    finally:
        TS.make_train_step = _MAKE_TRAIN_STEP
    launches = read_launches()
    torch.cuda.synchronize()
    st = step_stats(record)
    st.update(best=best, peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    for m in st["metrics"]:
        if not math.isfinite(m["loss"]):
            raise AssertionError(f"{cli.__name__}: non-finite loss {st['metrics']}")
    return st, launches


def expected_lr(i, lr, warm, total):
    """optax.warmup_cosine_decay_schedule at step ``i``, in float64."""
    warm, decay = max(1, warm), max(2, total) - max(1, warm)
    if i < warm:
        return lr * i / warm
    return lr * 0.5 * (1 + math.cos(math.pi * min(i - warm, decay) / decay))


def fusion_batch(gen, la, b=2, lt=128, emotions=4):
    """A padded full-width batch on the card: element 0 full length, element
    1 shorter in both modalities; multi-label targets."""
    dev = torch.device("cuda")
    mask = lambda l, short: (torch.arange(l)[None, :] >= torch.tensor([l, short])[:, None])  # noqa: E731
    return {"h_a": torch.randn(b, la, 768, generator=gen).to(dev),
            "h_t": torch.randn(b, lt, 768, generator=gen).to(dev),
            "mask_a": mask(la, la - 311).to(dev), "mask_t": mask(lt, 77).to(dev),
            "y": (torch.rand(b, emotions, generator=gen) > 0.5).float().to(dev)}


def grad_check(tag, dt, got, ref, whole=False):
    """Kernel-route gradients against the plain route's within
    ``GRAD_TOL[dt]`` in relative norm: each leaf in fp32, all leaves
    together in bf16 (and in fp32 with ``whole``). Returns the readings: the
    whole gradient's relative norm, the worst leaf's, and the worst max |d|
    / max |g| (reported, not held)."""
    worst_elem = worst_norm = 0.0
    d2 = r2 = 0.0
    worst_leaf = None
    for i, (g, r) in enumerate(zip(got, ref)):
        g, r = g.float(), r.float()
        if not torch.isfinite(g).all():
            raise AssertionError(f"{tag}: gradient leaf {i} is not finite")
        d_norm, r_norm = (g - r).norm().item(), r.norm().item()
        d2, r2 = d2 + d_norm ** 2, r2 + r_norm ** 2
        elem = (g - r).abs().max().item() / max(r.abs().max().item(), 1e-30)
        norm = d_norm / max(r_norm, 1e-30)
        if norm > worst_norm:
            worst_norm, worst_leaf = norm, i
        worst_elem = max(worst_elem, elem)
    whole_norm = math.sqrt(d2 / r2)
    reading = dict(rel_norm=whole_norm, worst_leaf_rel_norm=worst_norm, worst_leaf=worst_leaf,
                   max_over_max=worst_elem)
    if (worst_norm if dt == torch.float32 and not whole else whole_norm) > GRAD_TOL[dt]:
        raise AssertionError(f"{tag}: gradients kernel vs plain outside {GRAD_TOL[dt]} in "
                             f"relative norm: {reading}")
    return reading


def ffn_preactivations(model):
    """Forward hooks that keep each FFN's ReLU pre-activations (the first
    Linear's output of every ``MLP2``) of the forwards that follow, by
    module name. Returns ``(store, handles)``."""
    store, handles = {}, []
    for name, m in model.named_modules():
        if isinstance(m, MLP2):
            handles.append(m._modules["0"].register_forward_hook(
                lambda mod, inp, out, n=name: store.__setitem__(n, out.detach())))
    return store, handles


def relu_flips(pre_k, pre_p) -> int:
    """The number of FFN ReLU pre-activations that are positive in one route
    and not in the other, from each route's ``ffn_preactivations``."""
    return sum(int(((pre_k[n] > 0) != (pre_p[n] > 0)).sum()) for n in pre_k)


def dropped_block_check(gen, dt, la=2249, h=8, hd=96):
    """The flash backward's limit check: gradients of q, k and v from
    ``streaming_reference`` over all keys against a backward that drops the
    last, partial 512-key block (keys 2048..2248) must fail the gradient
    tolerance of ``grad_check``. Returns that wrong backward's readings."""
    dev = torch.device("cuda")
    q, k, v = (torch.randn(2, h, la, hd, generator=gen).to(dev, dt) for _ in range(3))
    g = torch.randn(2, h, la, hd, generator=gen).to(dev, dt)
    bias = FA.key_bias(torch.arange(la)[None, :].to(dev) >= torch.tensor([[la], [la - 311]],
                                                                          device=dev), 2, la, dev)
    kept = (la - 1) // FA.REF_BLOCK * FA.REF_BLOCK

    def grads(n):
        ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = FA.streaming_reference(ins[0], ins[1][:, :, :n], ins[2][:, :, :n], bias[:, :n])
        return torch.autograd.grad(out, ins, g)
    ref, wrong = grads(la), grads(kept)
    try:
        grad_check(f"flash backward {str(dt)[6:]} without its last key block", dt, wrong, ref)
    except AssertionError as e:
        print(f"  limit check: rejected, as it must be: {e}", flush=True)
        return dict(keys=f"{kept} of {la}", **{n: dict(
            max_over_max=((w - r).abs().max() / r.abs().max()).item(),
            rel_norm=((w - r).norm() / r.norm()).item()) for n, w, r in zip("qkv", wrong, ref)})
    raise AssertionError("the gradient tolerance passes a flash backward without its last "
                         "key block")


def fusion_step(gen, smi, classifier: bool = False, mosei: bool = False, heads: int = 8,
                dtypes=(torch.float32, torch.bfloat16)):
    """Phase 6c (6d with ``classifier``): train steps of the full-width
    fusion model (``FusionWithEmotionDecoder`` at d=768 in ``heads`` heads;
    ``FusionClassifier``, single-label; with ``mosei``
    ``MoseiFusionWithEmotionDecoder`` at the MOSEI trainer's d=256 in 8
    heads, hd 32, 6 emotions) at B=2, dropout 0, audio at 1499 and 2249
    frames with padding, in ``dtypes``: the one-pass and the streaming
    kernel forward with the recompute backward (at 4 heads, hd 192, on the
    wide tile instances). The first
    step's loss and gradients are held against the plain route
    (``use_kernels=False``) at the initial parameters (the bf16 loss at 4
    heads within ``WIDE_LOSS_RTOL``); then timed steps (the main path), peak
    step memory of both routes and the plain route's steps.
    Returns its record and the launches of its main-path steps."""
    rec, total = {}, dict.fromkeys(LAUNCH_NAMES, 0)
    what = ("classifier step" if classifier else
            "MOSEI 8-head train step" if mosei else
            "train step" if heads == 8 else f"{heads}-head train step")
    wide = 768 // heads > 128
    for la in TRAIN_AUDIO:
        for dt in dtypes:
            tag = f"L={la} {str(dt)[6:]}"
            if classifier:
                model = FusionClassifier(768, 4, 8, 2, 256, dropout=0.0)
                cfg = TS.TrainConfig(loss_type="single_label", schedule="constant",
                                     compute_dtype=dt)
            else:
                model = (MoseiFusionWithEmotionDecoder(768, 768, 256, 6, 8, 2, 2, 128,
                                                       dropout=0.0) if mosei else
                         FusionWithEmotionDecoder(768, 4, heads, 2, 2, 256, dropout=0.0))
                cfg = TS.TrainConfig(loss_type="multi_label", beta_degeneracy=0.01,
                                     schedule="constant", compute_dtype=dt)
            model.init_weights(torch.Generator().manual_seed(SEED + 6))
            model = model.to("cuda")
            batch = fusion_batch(gen, la, emotions=6 if mosei else 4)
            if classifier:
                batch["y"] = torch.randint(0, 4, (2,), generator=gen).cuda()

            # the classifier's loss reaches the audio rows mostly through the
            # 128 fused (text-length) rows, so a ReLU flip's changed row is a
            # large share of some leaves' gradients: in fp32 the whole
            # gradient is held at GRAD_TOL, each leaf read (PERF.md §6), and
            # the flips are counted. So is the decoder's fp32 step at 4 heads,
            # at WIDE_MAX_RELU_FLIPS: the 3xTF32 cores flip 3-11 FFN ReLUs of a
            # step where the CUDA-core kernel flips 1-3, and one flip in a
            # leaf read 1.8e-3 in norm; the narrow 8x96 cores read up to 1.0e-3
            # on other batches (PERF.md §6; chip_grad_flip_probe.py). The
            # worst leaf is printed beside GRAD_TOL.
            by_flips = classifier or (wide and dt == torch.float32)
            max_flips = MAX_RELU_FLIPS if classifier else WIDE_MAX_RELU_FLIPS
            out, pre = {}, {}
            for route in ("kernel", "plain"):
                set_use_kernels(model, route == "kernel")
                store, hooks = ffn_preactivations(model) if by_flips else ({}, [])
                out[route] = TS.compute_grads(model, cfg, batch)
                pre[route] = store
                for hk in hooks:
                    hk.remove()
            (loss_k, grads_k, _), (loss_p, grads_p, _) = out["kernel"], out["plain"]
            loss_err = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
            loss_tol = WIDE_LOSS_RTOL if wide and dt == torch.bfloat16 else LOSS_RTOL[dt]
            if not (math.isfinite(loss_k.item()) and loss_err <= loss_tol):
                raise AssertionError(f"{what} {tag}: loss {loss_k.item()} kernel route, "
                                     f"{loss_p.item()} plain (relative {loss_err:.3g})")
            grads = grad_check(f"{what} {tag}", dt, grads_k, grads_p, whole=by_flips)
            if by_flips:
                grads["relu_flips"] = relu_flips(pre["kernel"], pre["plain"])
                if dt == torch.float32 and grads["relu_flips"] > max_flips:
                    raise AssertionError(f"{what} {tag}: {grads['relu_flips']} ReLU decisions "
                                         f"differ between the routes (at most {max_flips})")
                if dt == torch.float32:
                    print(f"  {what} {tag}: whole gradient {grads['rel_norm']:.3g} (held at "
                          f"{GRAD_TOL[dt]}), worst leaf {grads['worst_leaf']} "
                          f"{grads['worst_leaf_rel_norm']:.3g} (beside {GRAD_TOL[dt]}, not held), "
                          f"{grads['relu_flips']} ReLU flips (at most {max_flips})", flush=True)
            del pre
            del out, grads_k, grads_p

            set_use_kernels(model, True)
            state = TS.create_train_state(model, cfg)
            step = TS.make_train_step(model, cfg)
            record = []
            timed_step = timed_steps(record)(model, cfg)
            reset_launches()
            for _ in range(3):
                state, _ = timed_step(state, batch)
            ll = read_launches()
            route = "onepass_attention" if la <= FA.ONEPASS_MAX_LK else "streaming_attention"
            want = {route: 6, f"{route} (wide tiles)": 6 if wide else 0}
            check_launches(f"{what} {tag}", ll, want)
            for name, n in ll.items():
                total[name] += n
            st = step_stats(record)
            profile_call(f"{what.replace(' ', '_').replace('-', '_')}_{la}_{str(dt)[6:]}",
                         lambda: timed_wall(lambda: step(state, batch)))

            peaks, plain_rec = {}, []
            for route in ("kernel", "plain"):
                set_use_kernels(model, route == "kernel")
                step(state, batch)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                step(state, batch)
                torch.cuda.synchronize()
                peaks[route] = (torch.cuda.max_memory_allocated() - base) / 2**30
            plain_step = timed_steps(plain_rec)(model, cfg)
            for _ in range(3):
                plain_step(state, batch)
            plain = step_stats(plain_rec)
            if not peaks["kernel"] < peaks["plain"]:
                raise AssertionError(f"{what} {tag}: peak memory {peaks['kernel']:.3f} GiB "
                                     f"on the kernel route, {peaks['plain']:.3f} on the plain one")
            rec[tag] = dict(launches=ll, step=st, plain_step=plain, peak_step_gib=peaks,
                            loss=loss_k.item(), loss_rel_err=loss_err, grads=grads)
            print(f"{what} {tag} B=2 ({smi}): step {st['median_wall_ms']:.3f} ms wall, "
                  f"{st['median_event_ms']:.3f} ms events, {st['steps_per_s']:.2f} steps/s "
                  f"(plain route {plain['median_wall_ms']:.3f} ms); peak step memory "
                  f"{peaks['kernel']:.3f} GiB (plain {peaks['plain']:.3f}); first step vs plain: "
                  f"loss rel err {loss_err:.3g}, gradients {grads}; launches {ll}", flush=True)
            del model, state, step, timed_step, plain_step
            torch.cuda.empty_cache()
    if not (classifier or mosei or heads != 8):
        rec["backward_last_block"] = {str(dt)[6:]: dropped_block_check(gen, dt)
                                      for dt in (torch.float32, torch.bfloat16)}
    return rec, total


def timed_wall(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t


def training(gen, smi, root: pathlib.Path):
    """Phase 6, in ``root``, where phase 7 finds its checkpoints and its
    MOSEI corpus. Returns its record and the launches of its main-path
    runs."""
    root.mkdir()
    rec, total = {}, dict.fromkeys(LAUNCH_NAMES, 0)

    # (a) the IEMOCAP decoder trainer at its full width, fp32 and bf16
    csv_path, audio_dir, text_dir = make_synthetic_iemocap(
        root / "iemocap", n=48, d=768, seq_level=True, max_la=500, max_lt=128, seed=SEED)
    for dtype in ("float32", "bfloat16"):
        out = root / f"iemocap_{dtype}"
        st, ll = run_trainer(TRAIN_IEMOCAP, [
            "--index_csv", str(csv_path), "--audio_dir", str(audio_dir), "--text_dir",
            str(text_dir), "--out_dir", str(out), "--epochs", "2", "--batch_size", "16",
            "--compute_dtype", dtype, "--seed", str(SEED)], f"train_iemocap_{dtype}")
        check_launches(f"IEMOCAP trainer {dtype}", ll, {})
        ckpt = torch.load(out / "best_fusion_seq_decoder.pt", map_location="cpu",
                          weights_only=False)
        FusionWithEmotionDecoder(768, 6, 8, 2, 2, 256).load_state_dict(
            ckpt["model_state_dict"], strict=True)
        rec[f"iemocap_{dtype}"] = st
        print(f"IEMOCAP trainer {dtype} (d=768, B=16, 500/128 frames; {smi}): {st['steps']} "
              f"steps, step {st['median_wall_ms']:.3f} ms wall, {st['median_event_ms']:.3f} ms "
              f"events, {st['steps_per_s']:.2f} steps/s, peak {st['peak_mem_gib']:.3f} GiB; "
              f"losses {[round(m['loss'], 4) for m in st['metrics']]}; best val acc "
              f"{st['best']:.4f}; checkpoint loads strictly", flush=True)

    # (b) the MOSEI trainer at its defaults (d=256, bf16, grad_accum 4,
    # warmup-cosine): 144 utterances, 100 in train, 3 steps an epoch
    csv_path, audio_dir, text_dir = make_synthetic_mosei(
        root / "mosei", n=144, max_la=300, max_lt=128, seed=SEED)
    epochs = 7
    st, ll = run_trainer(TRAIN_MOSEI, [
        "--index_csv", str(csv_path), "--audio_dir", str(audio_dir), "--text_dir",
        str(text_dir), "--out_dir", str(root / "mosei_run"), "--epochs", str(epochs)],
        "train_mosei")
    check_launches("MOSEI trainer", ll, {})
    total_steps = st["steps"]
    if total_steps != 3 * epochs:
        raise AssertionError(f"MOSEI trainer: {total_steps} steps, want {3 * epochs}")
    lrs = [m["lr"] for m in st["metrics"]]
    want = [expected_lr(i, 1e-4, int(0.1 * total_steps), total_steps) for i in range(total_steps)]
    if not np.allclose(lrs, want, rtol=1e-5, atol=1e-11):
        raise AssertionError(f"MOSEI trainer: lr {lrs}, want the warmup-cosine {want}")
    rec["mosei_bfloat16"] = st
    print(f"MOSEI trainer (defaults: d=256, bf16, B=8 x accum 4, 300/128 frames; {smi}): "
          f"{st['steps']} steps, step {st['median_wall_ms']:.3f} ms wall, "
          f"{st['median_event_ms']:.3f} ms events, {st['steps_per_s']:.2f} steps/s, peak "
          f"{st['peak_mem_gib']:.3f} GiB; lr {[f'{x:.3g}' for x in lrs[:5]]}...; losses "
          f"{[round(m['loss'], 4) for m in st['metrics'][:5]]}...; best macro AUC "
          f"{st['best']:.4f}", flush=True)

    # (c) the fusion step through the flash kernels: the IEMOCAP decoder's
    # 8 heads of 96, the MOSEI model's 8 heads of 32 (the tile instance at
    # 32), and the IEMOCAP decoder at --n_heads 4 (hd 192, the wide tile
    # instance) in bf16 and then in fp32 (after the bf16 steps, which keep
    # their batches)
    rec["fusion_step"], ll = fusion_step(gen, smi)
    rec["mosei_8_heads_step"], ll8 = fusion_step(gen, smi, mosei=True)
    rec["fusion_4_heads_step"], ll4 = fusion_step(gen, smi, heads=4, dtypes=(torch.bfloat16,))
    rec4_32, ll4_32 = fusion_step(gen, smi, heads=4, dtypes=(torch.float32,))
    rec["fusion_4_heads_step"].update(rec4_32)
    for name in total:
        total[name] += ll[name] + ll8[name] + ll4[name] + ll4_32[name]
    return rec, total


def wavlm_gradient(gen):
    """Phase 6c, the WavLM core's gradient: ``wavlm_fused_attention`` (the
    kernel forward, the backward recomputed through the plain version) at
    B=2 L=499, 12 heads of 64, element 1 padded by 77 keys, bf16 and fp32,
    against autograd through the plain version on the same inputs and
    upstream gradient: the forward within ``ATTN_TOL``, the gradients of q,
    k, v, gate, position_bias and the key bias bit-equal. Returns the
    readings."""
    rec, dev = {}, torch.device("cuda")
    b, h, l, hd = 2, 12, 499, 64
    for dt in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn(b, l, h * hd, generator=gen).to(dev, dt).view(b, l, h, hd)
                   .transpose(1, 2) for _ in range(3))
        gate = (torch.rand(b, h, l, generator=gen) * 1.5 + 0.5).to(dev, dt)
        pos = (torch.randn(h, l, l, generator=gen) * 0.3).to(dev, dt)
        kb = torch.where(torch.arange(l)[None, :] >= torch.tensor([[l], [l - 77]]),
                         AB.NEG_INF, 0.0).float().to(dev)
        g = torch.randn(b, h, l, hd, generator=gen).to(dev, dt)
        outs, grads = [], []
        for fn in (WA.wavlm_fused_attention, WA.wavlm_fused_attention_plain):
            ins = [t.detach().requires_grad_(True) for t in (q, k, v, gate, pos, kb)]
            out = fn(*ins)
            grads.append(torch.autograd.grad(out, ins, g))
            outs.append(out.detach())
        torch.cuda.synchronize()
        tag = f"B={b} L={l} {str(dt)[6:]}"
        err, med = compare(f"wavlm_fused_attention forward {tag}", outs[0], outs[1], ATTN_TOL[dt])
        unequal = [n for n, a, r in zip(("q", "k", "v", "gate", "position_bias", "key_bias"),
                                        *grads) if not torch.equal(a, r)]
        if unequal:
            raise AssertionError(f"wavlm_fused_attention {tag}: kernel-route gradients of "
                                 f"{unequal} differ from the plain route's")
        rec[str(dt)[6:]] = dict(forward_max_abs_err=err, forward_median=med,
                                gradients="bit-equal")
        print(f"wavlm_fused_attention gradient {tag}: forward max |d| {err:.3g} (median "
              f"{med:.2g}), the six gradients bit-equal to the plain route's", flush=True)
    return rec


def classifier_training(gen, smi, root: pathlib.Path):
    """Phase 6d: ``train_fusion_seq_level`` at its full width (d=768, 8
    heads, 2 layers, beta hidden 256, dropout 0.2, batch 16) on phase 6a's
    seq-level corpus, fp32 and bf16, two epochs; then ``FusionClassifier``
    train steps through the flash kernels against the plain route
    (``fusion_step``). Returns its record and the launches of its main-path
    runs."""
    rec, total = {}, dict.fromkeys(LAUNCH_NAMES, 0)
    data = ["--index_csv", str(root / "iemocap" / "iemocap_index_splits.csv"),
            "--audio_dir", str(root / "iemocap" / "features" / "audio"),
            "--text_dir", str(root / "iemocap" / "features" / "text")]
    for dtype in ("float32", "bfloat16"):
        out = root / f"fusion_seq_{dtype}"
        st, ll = run_trainer(TRAIN_SEQ, data + [
            "--out_dir", str(out), "--epochs", "2", "--compute_dtype", dtype, "--seed",
            str(SEED)], f"train_fusion_seq_{dtype}")
        check_launches(f"seq-level trainer {dtype}", ll, {})
        ckpt = torch.load(out / "best_fusion_seq.pt", map_location="cpu", weights_only=False)
        FusionClassifier(768, 6, 8, 2, 256).load_state_dict(ckpt["model_state_dict"],
                                                            strict=True)
        rec[f"fusion_seq_{dtype}"] = st
        print(f"seq-level trainer {dtype} (FusionClassifier d=768, B=16, 500/128 frames; "
              f"{smi}): {st['steps']} steps, step {st['median_wall_ms']:.3f} ms wall, "
              f"{st['median_event_ms']:.3f} ms events, {st['steps_per_s']:.2f} steps/s, peak "
              f"{st['peak_mem_gib']:.3f} GiB; losses "
              f"{[round(m['loss'], 4) for m in st['metrics']]}; best val acc "
              f"{st['best']:.4f}; checkpoint loads strictly", flush=True)
    rec["classifier_step"], ll = fusion_step(gen, smi, classifier=True)
    for name, n in ll.items():
        total[name] += n
    return rec, total


def remaining_trainers(smi, root: pathlib.Path):
    """Phase 6e: ``train_fusion_utter_level`` at its full width (d=768,
    batch 32) on a synthetic utter-level corpus, both baselines on it, and
    the MOSEI trainer at its defaults on phase 6b's corpus for 2 epochs with
    ``--resume``, then resumed to 4 with ``--trace_dir``: the restored train
    state must equal the saved one leaf by leaf, the log go on at epoch 3,
    the first resumed epoch leave a trace. Returns its record."""
    rec = {}
    csv_path, audio_dir, text_dir = make_synthetic_iemocap(
        root / "iemocap_utter", n=160, d=768, seq_level=False, seed=SEED)
    data = ["--index_csv", str(csv_path), "--audio_dir", str(audio_dir),
            "--text_dir", str(text_dir)]
    out = root / "fusion_utter"
    st, ll = run_trainer(TRAIN_UTT, data + ["--out_dir", str(out), "--epochs", "2",
                                            "--seed", str(SEED)], "train_fusion_utter")
    check_launches("utter-level trainer", ll, {})
    ckpt = torch.load(out / "best_fusion_utt.pt", map_location="cpu", weights_only=False)
    FusionClassifier(768, 6, 8, 2, 256).load_state_dict(ckpt["model_state_dict"], strict=True)
    rec["fusion_utter"] = st
    print(f"utter-level trainer (FusionClassifier d=768, B=32; {smi}): {st['steps']} steps, "
          f"step {st['median_wall_ms']:.3f} ms wall, {st['median_event_ms']:.3f} ms events, "
          f"{st['steps_per_s']:.2f} steps/s, peak {st['peak_mem_gib']:.3f} GiB; best val acc "
          f"{st['best']:.4f}", flush=True)

    for name, cli, keys in (("linear_probe", TRAIN_PROBE, {"modality"}),
                            ("text_baseline", TRAIN_TEXT, {"head", "best_val_macro_f1"})):
        out = root / name
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        secs = timed_wall(lambda: cli.main(data + ["--out_dir", str(out)]))
        metrics = json.loads((out / "metrics.json").read_text())
        splits = {"train", "val", "test"}
        if set(metrics) != keys | {"label2id"} | splits or not all(
                math.isfinite(metrics[sp]["acc"]) and metrics[sp]["n"] > 0 for sp in splits):
            raise AssertionError(f"{name}: metrics.json {metrics}")
        rec[name] = dict(seconds=secs, **{sp: metrics[sp] for sp in splits},
                         peak_gib_above_start=(torch.cuda.max_memory_allocated() - base) / 2**30)
        print(f"{name} (d=768 features, 160 utterances; {smi}): the whole call {secs:.3f} s, "
              f"peak {rec[name]['peak_gib_above_start']:.4f} GiB above its start; train acc "
              f"{metrics['train']['acc']:.4f}, val macro-F1 {metrics['val']['macro_f1']:.4f}",
              flush=True)

    mosei = root / "mosei"
    argv = ["--index_csv", str(mosei / "mosei_index_splits.csv"), "--audio_dir",
            str(mosei / "features" / "audio"), "--text_dir", str(mosei / "features" / "text"),
            "--out_dir", str(root / "mosei_resume"), "--resume"]
    first, _ = run_trainer(TRAIN_MOSEI, argv + ["--epochs", "2"], None)
    saved = torch.load(root / "mosei_resume" / "resume" / "state", weights_only=True)
    restored, restore = [], CK.restore_native

    def snapshot(path, like):  # the state as restored, before any step moves it
        out = restore(path, like)
        if not isinstance(like, dict):
            restored.append(CK.native_tree(out))
        return out
    CK.restore_native = snapshot
    try:
        second, _ = run_trainer(TRAIN_MOSEI, argv + ["--epochs", "4", "--trace_dir",
                                                     str(root / "trace")], None)
    finally:
        CK.restore_native = restore

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            yield from (leaves(v, f"{prefix}{k}.") if isinstance(v, dict) else
                        [(prefix + k, v)])
    got, want = dict(leaves(restored[0])), dict(leaves(saved))
    unequal = [k for k in want if k not in got or not torch.equal(got[k], want[k])]
    if len(restored) != 1 or set(got) != set(want) or unequal:
        raise AssertionError(f"MOSEI resume: the restored state differs from the saved one "
                             f"at {unequal[:5]} ({len(unequal)} leaves)")
    with open(root / "mosei_resume" / "outputs" / "train_log.csv", newline="") as f:
        epochs = [int(r["epoch"]) for r in csv.DictReader(f)]
    meta = json.loads((root / "mosei_resume" / "resume" / "meta.json").read_text())
    traces = sorted((root / "trace").glob("*.pt.trace.json"))
    if epochs != [3, 4] or meta["epoch"] != 4 or len(traces) != 1:
        raise AssertionError(f"MOSEI resume: log epochs {epochs}, meta epoch {meta['epoch']}, "
                             f"traces {traces}")
    rec["mosei_resume"] = dict(first=first, second=second, leaves=len(want),
                               step_restored=int(saved["step"]), log_epochs=epochs,
                               trace_bytes=traces[0].stat().st_size)
    print(f"MOSEI trainer --resume (defaults; {smi}): 2 epochs ({first['steps']} steps), then "
          f"resumed to 4 ({second['steps']} steps): {len(want)} leaves of the train state "
          f"restored bit-equal (step {int(saved['step'])}), log epochs {epochs}, trace "
          f"{traces[0].name} ({traces[0].stat().st_size} bytes); resumed step "
          f"{second['median_wall_ms']:.3f} ms wall (the traced epoch included)", flush=True)
    return rec


def hf_state_dict(module: torch.nn.Module, prefix: str) -> dict:
    """``module``'s weights (a port ``WavLMEncoder`` or ``BertEncoder``) as an
    HF checkpoint lays them out, the input of ``from_torch_state_dict``:
    names under ``prefix`` (``"wavlm."`` or ``"bert."``), WavLM's positional
    conv as weight norm's ``original0`` (g, the norm over dims (0, 1)) and
    ``original1`` (v, the weight), and the entries the bridges skip
    (``masked_spec_embed``; ``pooler.*`` and ``embeddings.position_ids``).
    Proves a bridge at full width, where no HF model can be built (the
    card's machine has no ``transformers``)."""
    sd = {}
    for name, t in module.state_dict().items():
        t = t.detach().float().cpu().clone()
        if name == "encoder.pos_conv_embed.conv.weight":
            base = prefix + name.removesuffix("weight") + "parametrizations.weight."
            sd[base + "original0"] = t.norm(dim=(0, 1), keepdim=True)
            sd[base + "original1"] = t
        else:
            sd[prefix + name] = t
    d = module.config.hidden_size
    if prefix == "wavlm.":
        sd[prefix + "masked_spec_embed"] = torch.zeros(d)
    else:
        sd[prefix + "pooler.dense.weight"] = torch.zeros(d, d)
        sd[prefix + "pooler.dense.bias"] = torch.zeros(d)
        sd[prefix + "embeddings.position_ids"] = torch.arange(
            module.config.max_position_embeddings)[None]
    return sd


def vocab_of(texts) -> list[str]:
    """A WordPiece vocabulary for the synthetic transcripts: the special
    tokens, every other word whole, and the rest as a two-letter head and
    single-letter ``##`` pieces, so that both kinds of match run."""
    words = sorted({w for t in texts for w in t.lower().split()})
    toks = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words[::2]
    for w in words[1::2]:
        toks += [w[:2]] + ["##" + c for c in w[2:]]
    return list(dict.fromkeys(toks))


def long_lengths(rng) -> dict:
    """Per split of ``LONG_MOSEI``, three utterances' (audio, text) frame
    counts: audio in the split's range, text in 64-128."""
    return {split: [(int(rng.integers(lo, hi + 1)), int(rng.integers(64, 129)))
                    for _ in range(3)] for split, (lo, hi) in LONG_MOSEI.items()}


def long_mosei(root: pathlib.Path, rng):
    """Uncapped MOSEI splits for the flash kernels: the utterances of
    ``long_lengths(rng)`` with 74-d audio and 300-d text features from
    ``rng``, labels in [-1, 3]. Returns ``(csv_path, audio_dir, text_dir)``."""
    audio_dir, text_dir = root / "features" / "audio", root / "features" / "text"
    rows = []
    for split, lengths in long_lengths(rng).items():
        for i, (la, lt) in enumerate(lengths):
            uid = f"{split}_{i}"
            save_feature(audio_dir / f"{uid}.npz",
                         rng.standard_normal((la, 74)).astype(np.float32), np.ones(la, np.int64))
            save_feature(text_dir / f"{uid}.npz",
                         rng.standard_normal((lt, 300)).astype(np.float32), np.ones(lt, np.int64))
            rows.append([uid, uid, split, *rng.uniform(-1, 3, len(MOSEI_EMO_COLS))])
    write_meta(audio_dir, hidden_dim=74, level="seq")
    write_meta(text_dir, hidden_dim=300, level="seq")
    csv_path = root / "mosei_index_splits.csv"
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerows([["uid", "video_id", "split", *MOSEI_EMO_COLS], *rows])
    return csv_path, audio_dir, text_dir


def by_uid(out_dir: pathlib.Path, split: str) -> dict:
    uids = (out_dir / f"{split}_uids.txt").read_text().split("\n")
    return dict(zip(uids, np.load(out_dir / f"{split}_y_prob.npy")))


def evaluation(smi, work: pathlib.Path, idx, wavlm, bert):
    """Phase 7: the HF bridges at full width, ``e2e_infer`` (int8 and bf16)
    and ``extract_iemocap`` with local weights on phase 5's tree, and
    ``mosei_eval_infer`` with ``mosei_summary_metrics`` on phase 6b's
    checkpoint, each entry point called in this process so that the launch
    counters count. Returns its record and the launches of its main-path
    runs (the kernel runs; the plain runs are references)."""
    rec, total = {}, dict.fromkeys(LAUNCH_NAMES, 0)
    root = work / "eval"
    root.mkdir()

    def add(ll):
        for name, n in ll.items():
            total[name] += n

    # (a) the bridges at full width: HF-layout files of phase 5's encoders
    rows = II.read_csv(idx)
    (root / "vocab.txt").write_text("\n".join(vocab_of(r["text"] for r in rows)) + "\n")
    for name, module in (("wavlm", wavlm), ("bert", bert)):
        torch.save(hf_state_dict(module, f"{name}."), root / f"{name}.pt")
    wavlm2 = WavLMEncoder(wavlm.config).from_torch_state_dict(
        EX.load_state_dict_file(root / "wavlm.pt"))
    bert2 = BertEncoder(bert.config).from_torch_state_dict(
        EX.load_state_dict_file(root / "bert.pt"))
    tok = WordPieceTokenizer(root / "vocab.txt")
    enc = tok([r["text"] for r in rows[:8]], max_length=128)
    if (enc["input_ids"] == tok.unk).any() or enc["attention_mask"].sum(1).min() <= 2:
        raise AssertionError("WordPiece: [UNK] or no tokens in the synthetic transcripts")
    gen = torch.Generator().manual_seed(SEED + 7)
    wav = torch.randn(2, 160000, generator=gen).cuda() * 0.1
    wmask = (torch.arange(160000)[None, :] < torch.tensor([[160000], [97000]])).int().cuda()
    ids = torch.from_numpy(enc["input_ids"]).cuda()
    tmask = torch.from_numpy(enc["attention_mask"]).cuda()
    with torch.inference_mode():
        outs = {}
        for tag, w, b in (("source", wavlm, bert), ("bridged", wavlm2, bert2)):
            w, b = copy.deepcopy(w).cuda().eval(), copy.deepcopy(b).cuda().eval()
            outs[tag] = (w(wav, wmask)[0], b(ids, tmask)[0])
            del w, b
    err = compare("bridged WavLM vs source, fp32", outs["bridged"][0], outs["source"][0],
                  FEATURE_TOL["float32"])
    if not torch.equal(outs["bridged"][1], outs["source"][1]):
        raise AssertionError("bridged BERT: not bit-equal to the source module")
    rec["bridges"] = dict(wavlm_max_abs_err=err[0], bert="bit-equal")
    print(f"bridges (WavLM base-plus, BERT-base, HF layout, weight norm folded): WavLM max "
          f"|d| {err[0]:.3g} (limit {FEATURE_TOL['float32']}), BERT bit-equal", flush=True)
    del outs, wavlm2, bert2
    torch.cuda.empty_cache()

    # (b) e2e_infer on the test split, int8 and bf16, each against its plain run
    fusion_ckpt = work / "train" / "iemocap_bfloat16" / "best_fusion_seq_decoder.pt"
    argv = ["--index_csv", str(idx), "--split", "test", "--num_emotions", "6",
            "--wavlm_state_dict", str(root / "wavlm.pt"), "--bert_state_dict",
            str(root / "bert.pt"), "--vocab_file", str(root / "vocab.txt"),
            "--fusion_ckpt", str(fusion_ckpt)]
    for tree, extra in (("int8", ["--int8"]), ("bf16", [])):
        out, plain = root / f"e2e_{tree}", root / f"e2e_{tree}_plain"
        reset_launches()
        secs = timed_wall(lambda: E2E.main(argv + extra + ["--out_dir", str(out)],
                                           cuda_graphs=False))
        ll = read_launches()
        E2E.main(argv + extra + ["--out_dir", str(plain)], use_kernels=False, cuda_graphs=False)
        got, ref = by_uid(out, "test"), by_uid(plain, "test")
        probs = np.stack([got[u] for u in sorted(ref)])
        delta = float(np.abs(probs - np.stack([ref[u] for u in sorted(ref)])).max())
        if set(got) != set(ref) or probs.shape[1] != 6 or not np.isfinite(probs).all() \
                or np.abs(probs.sum(1) - 1).max() > 1e-3:
            raise AssertionError(f"e2e {tree}: bad probabilities {probs}")
        print(f"e2e_infer {tree}: {len(got)} utterances in {secs:.3f} s (the whole CLI call, "
              f"weights loaded from disk), {len(got) / secs:.2f} utt/s ({smi}); kernel vs "
              f"plain max prob delta {delta:.3g} (gate {PROB_GATE}); launches {ll}", flush=True)
        if not delta <= PROB_GATE:
            raise AssertionError(f"e2e {tree}: prob delta {delta} > {PROB_GATE}")
        for name in E2E_KERNELS[tree]:
            if not ll[name]:
                raise AssertionError(f"e2e {tree}: {name} was not launched")
        add(ll)
        rec[f"e2e_{tree}"] = dict(utterances=len(got), seconds=secs, prob_delta=delta,
                                  launches=ll)

    # (c) extract_iemocap with the local weights and vocabulary, fp32, one batch
    def eargs(modality):
        return EX.parse_args(["--modality", modality, "--index_csv", str(idx),
                              "--out_dir", "unused", "--batch_size", "8",
                              "--wavlm_state_dict", str(root / "wavlm.pt"),
                              "--bert_state_dict", str(root / "bert.pt"),
                              "--vocab_file", str(root / "vocab.txt")])

    few = rows[:8]
    for d in ("x_audio", "x_audio_plain", "x_text"):
        (root / d).mkdir()
    reset_launches()
    st = EX.extract_audio(eargs("audio"), few, root / "x_audio")
    ll = read_launches()
    check_launches("extract with local weights", ll,
                   {n: k * st["forwards"] for n, k in PER_FORWARD_EXTRACT.items()})
    add(ll)
    EX.extract_audio(eargs("audio"), few, root / "x_audio_plain", use_kernels=False)
    reading = compare_features("extract with local weights, kernels vs plain",
                               root / "x_audio", root / "x_audio_plain",
                               [r["utter_id"] for r in few], FEATURE_TOL["float32"])
    EX.extract_text(eargs("text"), few, root / "x_text")
    for r in few:
        if load_feature(root / "x_text" / f"{r['utter_id']}.npz")[1].sum() <= 2:
            raise AssertionError("extract text: the WordPiece ids did not reach BERT")
    rec["extract_local"] = dict(reading, launches=ll)

    # (d) mosei_eval_infer on phase 6b's checkpoint: capped at its 300 frames
    # with every dump, then uncapped over long splits through the flash kernels
    train = work / "train"
    ckpt = train / "mosei_run" / "best_mosei_fusion_decoder.pt"
    data = ["--index_csv", str(train / "mosei" / "mosei_index_splits.csv"),
            "--audio_dir", str(train / "mosei" / "features" / "audio"),
            "--text_dir", str(train / "mosei" / "features" / "text")]
    dump = root / "mosei_dump"
    reset_launches()
    MEVAL.main(["--ckpt", str(ckpt), *data, "--splits", "val", "--dump_beta", "--dump_attn",
                "--out_dir", str(dump)])
    add(read_launches())
    MEVAL.main(["--ckpt", str(ckpt), *data, "--splits", "val", "--out_dir", str(root / "bare")])
    probs = np.load(dump / "val_y_prob.npy")
    n = len(probs)
    attn = torch.load(dump / "val_attentions.pt", weights_only=False)
    layer = attn["encoder"][0][0]
    shapes_ok = (probs.shape == (n, 6) and np.load(dump / "val_y_true.npy").shape == (n, 6)
                 and np.load(dump / "val_beta_mean.npy").shape == (n,)
                 and len(attn["encoder"][0]) == 2 and len(attn["decoder"][0]) == 2
                 and layer["audio_self"].shape[1:] == (300, 300)
                 and attn["decoder"][0][0].shape[1] == 6
                 and sum(len(b[0]["text_self"]) for b in attn["encoder"]) == min(n, 16))
    if not shapes_ok or not np.isfinite(probs).all():
        raise AssertionError(f"mosei_eval_infer: artifacts of the wrong shape: {probs.shape}, "
                             f"{ {k: tuple(v.shape) for k, v in layer.items()} }")
    if not np.array_equal(probs, np.load(root / "bare" / "val_y_prob.npy")):
        raise AssertionError("mosei_eval_infer: y_prob differs with --dump_attn")
    summary = MSUM.main(["--pred_dir", str(dump), "--split", "val", "--ckpt", str(ckpt)])

    ck = load_torch_checkpoint(str(ckpt))
    ck["args"].update(max_len_audio=0, max_len_text=0)
    save_torch_checkpoint(str(root / "mosei_uncapped.pt"), ck)
    csv_path, audio_dir, text_dir = long_mosei(root / "long", np.random.default_rng(SEED + 7))
    argv = ["--ckpt", str(root / "mosei_uncapped.pt"), "--index_csv", str(csv_path),
            "--audio_dir", str(audio_dir), "--text_dir", str(text_dir),
            "--splits", *LONG_MOSEI]
    reset_launches()
    MEVAL.main(argv + ["--out_dir", str(root / "long_out")])
    ll = read_launches()
    MEVAL.main(argv + ["--out_dir", str(root / "long_plain")], use_kernels=False)
    delta = max(float(np.abs(np.load(root / "long_out" / f"{sp}_y_prob.npy")
                             - np.load(root / "long_plain" / f"{sp}_y_prob.npy")).max())
                for sp in LONG_MOSEI)
    print(f"mosei_eval_infer (phase 6b's checkpoint, bf16): capped {n} utterances, artifacts "
          f"and attention dumps of the right shapes, y_prob unchanged by --dump_attn, summary "
          f"{summary}; uncapped {list(LONG_MOSEI.values())} frames: kernel vs plain max prob "
          f"delta {delta:.3g} (limit {EVAL_TOL}); launches {ll}", flush=True)
    if not delta <= EVAL_TOL:
        raise AssertionError(f"mosei_eval_infer uncapped: prob delta {delta} > {EVAL_TOL}")
    check_launches("mosei_eval_infer uncapped", ll,
                   {"onepass_attention": 2, "streaming_attention": 2})
    add(ll)
    # the same uncapped splits in fp16 through the fp16 kernels
    reset_launches()
    MEVAL.main(argv + ["--amp_dtype", "fp16", "--out_dir", str(root / "long_fp16")])
    ll16 = read_launches()
    MEVAL.main(argv + ["--amp_dtype", "fp16", "--out_dir", str(root / "long_fp16_plain")],
               use_kernels=False)
    delta16 = max(float(np.abs(np.load(root / "long_fp16" / f"{sp}_y_prob.npy")
                               - np.load(root / "long_fp16_plain" / f"{sp}_y_prob.npy")).max())
                  for sp in LONG_MOSEI)
    vs_bf16 = max(float(np.abs(np.load(root / "long_fp16" / f"{sp}_y_prob.npy")
                               - np.load(root / "long_out" / f"{sp}_y_prob.npy")).max())
                  for sp in LONG_MOSEI)
    print(f"mosei_eval_infer --amp_dtype fp16 uncapped: kernel vs plain max prob delta "
          f"{delta16:.3g} (limit {EVAL_TOL}), fp16 vs bf16 kernels {vs_bf16:.3g}; launches "
          f"{ll16}", flush=True)
    if not delta16 <= EVAL_TOL:
        raise AssertionError(f"mosei_eval_infer fp16 uncapped: prob delta {delta16} > {EVAL_TOL}")
    check_launches("mosei_eval_infer fp16 uncapped", ll16,
                   {"onepass_attention": 2, "streaming_attention": 2})
    add(ll16)
    # the MOSEI model at --n_heads 8 (d=256 in heads of 32, the tile instance
    # at 32) and at --n_heads 1 (one head of 256, the wide tile instance):
    # phase 6b's weights under a checkpoint of that head count (the head count
    # changes no parameter's shape), the same uncapped splits, bf16; then
    # --n_heads 1 at --amp_dtype off (fp32 on the wide tiles)
    by_heads = {}
    for nh, amp in ((8, "bf16"), (1, "bf16"), (1, "off")):
        ck["args"]["n_heads"] = nh
        save_torch_checkpoint(str(root / f"mosei_uncapped_{nh}h.pt"), ck)
        argv_h = ["--ckpt", str(root / f"mosei_uncapped_{nh}h.pt"), *argv[2:],
                  "--n_heads", str(nh), "--amp_dtype", amp]
        out_h = root / f"long_{nh}h_{amp}"
        reset_launches()
        MEVAL.main(argv_h + ["--out_dir", str(out_h)])
        ll_h = read_launches()
        MEVAL.main(argv_h + ["--out_dir", f"{out_h}_plain"], use_kernels=False)
        delta_h = max(float(np.abs(np.load(out_h / f"{sp}_y_prob.npy")
                                   - np.load(f"{out_h}_plain/{sp}_y_prob.npy")).max())
                      for sp in LONG_MOSEI)
        print(f"mosei_eval_infer --n_heads {nh} --amp_dtype {amp} uncapped: kernel vs plain "
              f"max prob delta {delta_h:.3g} (limit {EVAL_TOL}); launches {ll_h}", flush=True)
        if not delta_h <= EVAL_TOL:
            raise AssertionError(f"mosei_eval_infer {nh} heads --amp_dtype {amp} uncapped: prob "
                                 f"delta {delta_h} > {EVAL_TOL}")
        wide = 2 if 256 // nh > 128 else 0
        check_launches(f"mosei_eval_infer {nh} heads --amp_dtype {amp} uncapped", ll_h,
                       {"onepass_attention": 2, "streaming_attention": 2,
                        "onepass_attention (wide tiles)": wide,
                        "streaming_attention (wide tiles)": wide})
        add(ll_h)
        by_heads[nh, amp] = (delta_h, ll_h)
    (delta8, ll8), (delta1, ll1), (delta1_32, ll1_32) = by_heads.values()
    rec["mosei"] = dict(utterances=n, summary=summary, uncapped_prob_delta=delta, launches=ll,
                        uncapped_fp16_prob_delta=delta16, fp16_vs_bf16=vs_bf16,
                        fp16_launches=ll16, uncapped_8_heads_prob_delta=delta8,
                        launches_8_heads=ll8, uncapped_1_head_prob_delta=delta1,
                        launches_1_head=ll1, uncapped_1_head_fp32_prob_delta=delta1_32,
                        launches_1_head_fp32=ll1_32)
    return rec, total


# phase 8b: the int8 numerics report at full width. The outlier goes into one
# WavLM layer's FFN: intermediate_dense's output row OUTLIER_ROW scaled up by
# OUTLIER_SCALE and output_dense's input column OUTLIER_ROW scaled down by it,
# so that the float model is nearly unchanged while output_dense sees one
# channel dominate its input rows and its per-row int8 scales crush every
# other channel. The card's readings (``--outlier-sweep``; PERF.md §6;
# NVIDIA H100 80GB HBM3, 700 W): clean, max |d prob| 0.0017; the row alone
# stays inside the envelope (0.0012-0.0046 at scales 3-1000, layers 0, 5, 7,
# 11), since the outlier then dominates the float output as much as the int8
# one; row and column at scale 1000 blow it clearly at layer 7 alone (0.0188;
# 0.0017 with its output_dense reverted; 0.0016-0.0051 at the other layers).
REPORT_ENVELOPE = 0.005      # the runbook's default (--int8-envelope)
OUTLIER_LAYER, OUTLIER_ROW, OUTLIER_SCALE = 7, 7, 1000.0


def kernel_numerics(smi: str):
    """Phase 8a: every serving kernel against its plain version at every
    audio bucket (``hriemo_torch.tools.kernel_numerics``), B=8, full width;
    the rows go to ``chip_smoke_out/kernel_numerics_h100.json``."""
    from hriemo_torch.tools import kernel_numerics as KN

    reset_launches()
    results = KN.Checks("cuda", SEED).run_all(lambda line: print("  " + line, flush=True))
    rep = KN.report(results, smi, SEED)
    (OUT / "kernel_numerics_h100.json").write_text(json.dumps(rep, indent=1))
    missing = set(KN.expected_rows()) - {(r["kernel"], r["shape"]) for r in rep["rows"]}
    bad = [r for r in rep["rows"] if not r["max_delta"] <= r["threshold"]]
    if missing or bad:
        raise AssertionError(f"kernel numerics: missing {sorted(missing)}, over their limit {bad}")
    worst = {}
    for r in rep["rows"]:
        if r["max_delta"] >= worst.get(r["kernel"], {"max_delta": -1})["max_delta"]:
            worst[r["kernel"]] = r
    print("kernel numerics (B=8, every bucket): largest delta per kernel "
          + "; ".join(f"{k} {r['max_delta']:.3g} at {r['shape']} (limit {r['threshold']})"
                      for k, r in worst.items()), flush=True)
    return {"rows": len(rep["rows"]), "worst": worst}


def report_inputs(rng, dev):
    """Four requests of 10 s (499 WavLM frames) and their texts, 24-64
    tokens padded to 64: waveform, its mask, ids and their mask, as the
    report's ``apply_fn`` takes them. The clips fill their bucket: at random
    weights (LayerNorm biases 0, positional conv bias 0) a padded frame is an
    all-zero row at WavLM layer 0, whose crest reads 1e4 (the amax floor 1e-8
    over the rms floor 1e-12, in both packages) and would outrank any real
    outlier."""
    wav = (rng.standard_normal((4, 160000)) * 0.1).astype(np.float32)
    wmask = np.ones((4, 160000), np.int32)
    ntok = [64, int(rng.integers(24, 64)), int(rng.integers(24, 64)), 24]
    ids = rng.integers(1000, 30000, (4, 64))
    tmask = (np.arange(64)[None, :] < np.array(ntok)[:, None]).astype(np.int32)
    return tuple(torch.from_numpy(a).to(dev) for a in (wav, wmask, ids, tmask))


@functools.lru_cache(maxsize=1)
def _report_base():
    from hriemo_torch.tools.validate_pretrained_bridges import serving_stack

    return serving_stack(*serving_models(torch.Generator().manual_seed(SEED)))


def report_stack(outlier_scale: float | None, layer: int = OUTLIER_LAYER,
                 compensate: bool = True):
    """WavLM base-plus, BERT-base and the fusion model (d=768) from seed 0 on
    the card in fp32, under the runbook's names; with ``outlier_scale`` the
    WavLM FFN of ``layer`` with its channel ``OUTLIER_ROW`` scaled up by it
    going in and (``compensate``) down by it going out."""
    stack = copy.deepcopy(_report_base())
    if outlier_scale is not None:
        with torch.no_grad():
            ff = stack["w"].encoder.layers[layer].feed_forward
            ff["intermediate_dense"].weight[OUTLIER_ROW] *= outlier_scale
            ff["intermediate_dense"].bias[OUTLIER_ROW] *= outlier_scale
            if compensate:
                ff["output_dense"].weight[:, OUTLIER_ROW] /= outlier_scale
    return stack.to("cuda", torch.float32).eval()


def int8_report(smi: str):
    """Phase 8b: ``int8_numerics_report`` on the full-width stack and 4
    requests through the kernels, on clean weights, then with the outlier.
    The outlier run must blow the envelope, revert the layer downstream of
    the outlier first and end within it; the reverted tree must serve through
    the kernels, its split FFN per op and every whole block on its kernel;
    so must the clean trees of SPLIT_TREES (a BERT MHA and a WavLM attention
    sublayer split). Returns its record and the launches of the split trees'
    forwards."""
    from hriemo_torch.tools.validate_pretrained_bridges import stack_apply

    apply_fn = stack_apply(multi_label=True)
    args = report_inputs(np.random.default_rng(SEED + 12), torch.device("cuda"))
    rec = {}
    for tag, scale in (("clean", None), ("outlier", OUTLIER_SCALE)):
        stack = report_stack(scale)
        t = time.perf_counter()
        rep = Q.int8_numerics_report(apply_fn, stack, args, envelope=REPORT_ENVELOPE)
        secs = time.perf_counter() - t
        top = sorted(rep["activation_amax"].items(), key=lambda kv: -kv[1]["crest_p90"])[:3]
        print(f"int8 report {tag} (WavLM base-plus, BERT-base, fusion d=768, fp32, 4 requests, "
              f"kernels; {smi}): {rep['n_quantized_layers']} int8 layers; full int8 deltas "
              f"{rep['deltas_full_int8']}; reverted {rep['reverted_layers']}; final "
              f"{rep['deltas_final']}; within_envelope {rep['within_envelope']} "
              f"(envelope {REPORT_ENVELOPE}); top crest_p90 "
              f"{[(n, round(v['crest_p90'], 2)) for n, v in top]}; {secs:.1f} s", flush=True)
        rec[tag] = dict(seconds=secs, **{k: v for k, v in rep.items() if k != "activation_amax"},
                        top_crest=[(n, v) for n, v in top])
        if tag == "clean":
            continue
        want = f"w/encoder/layers/{OUTLIER_LAYER}/feed_forward/output_dense"
        if not rep["deltas_full_int8"]["probs"] > REPORT_ENVELOPE:
            raise AssertionError(f"int8 report: the outlier left the envelope whole: {rep}")
        if not rep["reverted_layers"] or rep["reverted_layers"][0] != want:
            raise AssertionError(f"int8 report: reverted {rep['reverted_layers']}, {want} first "
                                 "expected")
        if not rep["within_envelope"]:
            raise AssertionError(f"int8 report: still outside the envelope: {rep['deltas_final']}")
        rec["served"], launches = serve_split(stack, apply_fn, args, rep["reverted_layers"])
        del stack
        torch.cuda.empty_cache()
    # one Linear of a BERT MHA and of a WavLM attention sublayer kept in full
    # precision, on the clean weights
    stack = report_stack(None)
    for path in SPLIT_TREES:
        rec[path], ll = serve_split(stack, apply_fn, args, [path])
        for name, n in ll.items():
            launches[name] += n
    return rec, launches


# trees with one Linear of a fused block kept in full precision: the block
# runs per op, so its kernel launches once fewer a forward and its int8
# Linears that stay int8 go through int8_linear (the WavLM attention's core
# through the fused float core at 499 frames); every other block as before
SPLIT_BLOCKS = {
    "feed_forward/output_dense": {"ffn_block_int8": -1, "int8_linear": 1},
    "attention/self/key": {"mha_block_int8": -1, "int8_linear": 3},
    "attention/k_proj": {"attention_block_int8": -1, "int8_linear": 3,
                         "wavlm_fused_attention": 1},
}
SPLIT_TREES = ("b/encoder/layer/0/attention/self/key", "w/encoder/layers/3/attention/k_proj")


def serve_split(stack, apply_fn, args, exclude):
    """The int8 tree with ``exclude`` (paths ending in a key of
    SPLIT_BLOCKS) kept in full precision, through the kernels, against the
    whole int8 tree: launch counts moved by SPLIT_BLOCKS and no more, and
    probabilities within the gate of the tree's plain route. Returns the
    readings and the tree's launches."""
    counts, outs = {}, {}
    for tag, paths in (("whole", frozenset()), ("split", frozenset(exclude))):
        q = quantize_for_serving(copy.deepcopy(stack), exclude=paths)
        with torch.no_grad():
            apply_fn(q, *args)      # first calls of each shape
            reset_launches()
            outs[tag] = apply_fn(q, *args)
            torch.cuda.synchronize()
            counts[tag] = read_launches()
            if tag == "split":
                ref = apply_fn(set_use_kernels(q, False), *args)
        del q
    want = dict(counts["whole"])
    for p in exclude:
        moves = next(m for suffix, m in SPLIT_BLOCKS.items() if p.endswith(suffix))
        for name, n in moves.items():
            want[name] += n
    check_launches(f"tree without {sorted(exclude)}", counts["split"], want)
    delta = float((outs["split"]["probs"] - ref["probs"]).abs().max())
    print(f"int8 tree without {sorted(exclude)} through the kernels: launches "
          f"{counts['split']} (whole int8 tree {counts['whole']}); kernel vs plain max prob "
          f"delta {delta:.3g} (gate {PROB_GATE})", flush=True)
    if not delta <= PROB_GATE:
        raise AssertionError(f"tree without {sorted(exclude)}: prob delta {delta} > {PROB_GATE}")
    return dict(launches=counts["split"], whole=counts["whole"], prob_delta=delta), \
        counts["split"]


def outlier_sweep(smi: str) -> int:
    """``--outlier-sweep``: the readings OUTLIER_* were chosen from. The
    report's full-int8 probability delta (kernels, 4 requests) with the
    outlier channel scaled in only (3-1000 at layers 0, 5, 7, 11), and in and
    out at 1000 at every WavLM layer, each with the layers it reverts."""
    from hriemo_torch.tools.validate_pretrained_bridges import stack_apply

    apply_fn = stack_apply(multi_label=True)
    args = report_inputs(np.random.default_rng(SEED + 12), torch.device("cuda"))
    runs = [(None, OUTLIER_LAYER, True)]
    runs += [(sc, layer, False) for layer in (0, 5, 7, 11) for sc in (3.0, 30.0, 300.0, 1000.0)]
    runs += [(1000.0, layer, True) for layer in range(12)]
    for scale, layer, compensate in runs:
        rep = Q.int8_numerics_report(apply_fn, report_stack(scale, layer, compensate), args,
                                     envelope=REPORT_ENVELOPE, max_reverts=1)
        print(f"outlier sweep ({smi}): scale {scale} layer {layer} "
              f"{'in and out' if compensate else 'in only'}: full int8 |d prob| "
              f"{rep['deltas_full_int8']['probs']:.6f}, reverted {rep['reverted_layers']}, "
              f"final {rep['deltas_final']['probs']:.6f}", flush=True)
        torch.cuda.empty_cache()
    return 0


def feature_loader(smi: str, root: pathlib.Path):
    """Phase 8c: the C++ feature loader (``hriemo_torch/native.py``) built
    from the checkout; ``BucketBatcher(native=True)`` batches bit-equal to
    the Python loader's on phase 6b's corpus (its caps, batch 8 x accum 4,
    shuffled, then the eval layout); then the MOSEI trainer at 6b's settings
    for one epoch with ``--native_loader``, which must run the C++ loader,
    against the same epoch on the Python loader."""
    from hriemo_torch import native
    from hriemo_torch import data as D

    t = time.perf_counter()
    if not native.is_available():
        raise AssertionError("feature loader: the C++ library did not build or load")
    build_s = time.perf_counter() - t
    mosei = root / "mosei"
    rows, cols = D.read_index_csv(mosei / "mosei_index_splits.csv")
    ds = D.SeqLevelDataset(rows, mosei / "features" / "audio", mosei / "features" / "text",
                           emo_cols=list(MOSEI_EMO_COLS), max_len_audio=300, max_len_text=128,
                           verbose=False, columns=cols)
    rec = dict(build_s=build_s, items=len(ds))
    for tag, kw in (("train", dict(shuffle=True, seed=SEED, grad_accum=4, drop_last=True)),
                    ("eval", dict(drop_last=False))):
        secs, batches = {}, {}
        for native_on in (False, True):
            bb = D.BucketBatcher(ds, 8, la=300, lt=128, native=native_on, **kw)
            if bb.native != native_on:
                raise AssertionError(f"feature loader: BucketBatcher(native={native_on}) ran "
                                     f"the {'C++' if bb.native else 'Python'} loader")
            t = time.perf_counter()
            batches[native_on] = list(bb)
            secs[native_on] = time.perf_counter() - t
        for bp, bn in zip(batches[False], batches[True], strict=True):
            if bp.keys() != bn.keys() or bp["uids"] != bn["uids"] \
                    or bp["n_valid"] != bn["n_valid"] or any(
                        bp[k].dtype != bn[k].dtype or not np.array_equal(bp[k], bn[k])
                        for k in bp if k not in ("uids", "n_valid")):
                raise AssertionError(f"feature loader: {tag} batches differ from the Python "
                                     "loader's")
        rec[tag] = dict(batches=len(batches[True]), python_s=secs[False], native_s=secs[True])
        print(f"feature loader {tag} ({len(batches[True])} batches of phase 6b's corpus): "
              f"bit-equal to the Python loader; assembly {secs[True] * 1e3:.1f} ms native, "
              f"{secs[False] * 1e3:.1f} ms Python (host)", flush=True)

    made = []

    class Recorded(D.BucketBatcher):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    argv = ["--index_csv", str(mosei / "mosei_index_splits.csv"), "--audio_dir",
            str(mosei / "features" / "audio"), "--text_dir", str(mosei / "features" / "text"),
            "--epochs", "1"]
    runs, python_batcher = {}, D.BucketBatcher
    D.BucketBatcher = Recorded
    try:
        for native_on in (False, True):
            made.clear()
            flags = ["--native_loader"] if native_on else []
            runs[native_on], ll = run_trainer(TRAIN_MOSEI, argv + flags + [
                "--out_dir", str(root / f"mosei_loader_{int(native_on)}")], None)
            check_launches("MOSEI trainer --native_loader", ll, {})
            if len(made) != 2 or any(b.native != native_on for b in made):
                raise AssertionError(f"MOSEI trainer: loaders {[b.native for b in made]}, "
                                     f"native={native_on} expected")
    finally:
        D.BucketBatcher = python_batcher
    losses = {k: [m["loss"] for m in r["metrics"]] for k, r in runs.items()}
    if not np.allclose(losses[True], losses[False], rtol=LOSS_RTOL[torch.bfloat16]):
        raise AssertionError(f"MOSEI trainer --native_loader: losses {losses[True]} against "
                             f"{losses[False]} on the Python loader")
    rec["trainer"] = dict(steps=runs[True]["steps"], losses=losses[True],
                          python_losses=losses[False], best=runs[True]["best"])
    print(f"MOSEI trainer --native_loader (6b's settings, 1 epoch; {smi}): the C++ loader ran "
          f"for train and val, {runs[True]['steps']} steps, losses {losses[True]} (Python "
          f"loader {losses[False]})", flush=True)
    return rec


# phase 9: the (data x model) mesh at full width on the one card. Two ranks
# share it over gloo with CUDA tensors (NCCL puts no two ranks on one device;
# gloo takes CUDA tensors for all_reduce and broadcast, which is all the
# train and eval steps use). Two ranks on one card measure correctness, not
# scaling. The ring across ranks waits for a card per rank: gloo refuses
# CUDA tensors point to point (PERF.md §6), and the rotation is
# never staged through the host.
MESH_SHAPES = {"dp": (2, 1), "tp": (1, 2)}
MESH_B = 4                 # the whole batch of the mesh steps, 2 rows per data rank
MESH_LR = 1e-4             # TrainConfig's default, the steps' lr
# the parameters after one step, mesh against one process: the difference of
# the two updates in relative norm of the single-process update (all leaves
# together). Adam's first step is about lr sign(g), so a gradient element
# within rounding noise of 0 steps either way and adds 2 lr to the
# difference; a block in the wrong place would differ by the whole update
# (relative norm ~1.4). The card read at most 9.7e-4 in fp32 and 0.162 in
# bf16 (TP at 1499 frames: bf16 partial sums; PERF.md §6).
PARAM_TOL = {torch.float32: 1e-2, torch.bfloat16: 0.5}
DP_SERVE_TOL = 5e-3        # __graft_entry__.py:322-331, JAX's sharded-vs-single limit
RING_SHAPE = (2, 8, 2249, 96)
SPAWN_TIMEOUT = 900


def serving_kwargs():
    """The StreamingPipeline settings of phases 4 and 9d: eager, so that the
    kernels' launch counters count every forward (a graph replay launches
    without Python; phase 10 holds the graphs to these pipelines)."""
    return dict(tokenizer=HashTokenizer(30522), max_seconds=10.0, max_tokens=128,
                multi_label=False, bucket_seconds=(2.5,), int8_frontends=True,
                wav_transport="pcm16", text_bucket_tokens=TEXT_BUCKETS, cuda_graphs=False)


def mesh_batch(la):
    """The full-width batch of phase 9's steps (B=4, audio ``la`` frames,
    each element padded differently), the same on every rank."""
    gen = torch.Generator().manual_seed(SEED + 9)
    lens = lambda l, cuts: torch.tensor([l - c for c in cuts])  # noqa: E731
    mask = lambda l, cuts: torch.arange(l)[None, :] >= lens(l, cuts)[:, None]  # noqa: E731
    return {"h_a": torch.randn(MESH_B, la, 768, generator=gen).cuda(),
            "h_t": torch.randn(MESH_B, 128, 768, generator=gen).cuda(),
            "mask_a": mask(la, (0, 311, 97, 640)).cuda(),
            "mask_t": mask(128, (0, 51, 13, 77)).cuda(),
            "y": (torch.rand(MESH_B, 4, generator=gen) > 0.5).float().cuda()}


def mesh_model(dropout):
    model = FusionWithEmotionDecoder(768, 4, 8, 2, 2, 256, dropout=dropout)
    model.init_weights(torch.Generator().manual_seed(SEED + 6))
    return model.to("cuda")


def timed_mesh_steps(step, state, batch, gen_fn, n=2):
    """Median wall ms of ``n`` steps, each closed by a synchronisation."""
    ms = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(state, batch, gen_fn())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    return float(np.median(ms))


def mesh_step_case(meshes, kind, la, dt, dropout, lead):
    """One phase 9a/9b case on this rank: the mesh step (every rank) and, on
    rank 0, the single-process step on the whole batch, each from the same
    parameters; their gradients (the mesh's averaged over the data group,
    made whole), losses and updated parameters held against each other.
    Returns its readings (rank 0) and this rank's launches."""
    from hriemo_torch.parallel import mesh as PM

    mesh = meshes[kind]
    tag = f"{kind} L={la} {str(dt)[6:]} dropout {dropout}"
    cfg = TS.TrainConfig(loss_type="multi_label", beta_degeneracy=0.01, schedule="constant",
                         lr=MESH_LR, compute_dtype=dt)
    batch = mesh_batch(la)
    dev = batch["h_a"].device
    gen_fn = (lambda: torch.Generator(dev).manual_seed(SEED + 11)) if dropout else (  # noqa: E731
        lambda: None)
    seen, apply_update = [], TS.apply_update

    def recording(state, grads, *a, **k):
        seen.append([g.detach().clone() for g in grads])
        return apply_update(state, grads, *a, **k)

    TS.apply_update = recording
    try:
        rec = {}
        if lead:  # the single-process reference: not the main path, not counted
            single = mesh_model(dropout)
            before = [p.detach().clone() for p in single.parameters()]
            state = TS.create_train_state(single, cfg)
            step = TS.make_train_step(single, cfg)
            _, m1 = step(state, batch, gen_fn())
            ref_grads, ref_after = seen.pop(), [p.detach().clone() for p in single.parameters()]
            rec["single_ms"] = timed_mesh_steps(step, state, batch, gen_fn)
            seen.clear()
            del single, state, step
        model = mesh_model(dropout)
        state = TS.create_train_state(model, cfg, mesh)
        step = TS.make_train_step(model, cfg, mesh)
        local = PM.shard_batch(batch, mesh)
        reset_launches()
        _, m2 = step(state, local, gen_fn())
        specs = list(PM.param_shardings(mesh, model).values())
        grads = [PM.full_tensor(g, s, mesh) for g, s in zip(seen.pop(), specs)]
        after = [PM.full_tensor(p.detach(), s, mesh).clone()
                 for p, s in zip(model.parameters(), specs)]
        rec["mesh_ms"] = timed_mesh_steps(step, state, local, gen_fn)
        launches = read_launches()
        seen.clear()
    finally:
        TS.apply_update = apply_update
    want = {} if dropout else {  # the audio self-attention of both fusion layers, 3 steps
        "onepass_attention" if la <= FA.ONEPASS_MAX_LK else "streaming_attention": 2 * 3}
    check_launches(f"mesh step {tag}", launches, want)
    if lead:
        loss_err = abs(m2["loss"].item() - m1["loss"].item()) / abs(m1["loss"].item())
        if not (math.isfinite(m2["loss"].item()) and loss_err <= LOSS_RTOL[dt]):
            raise AssertionError(f"mesh step {tag}: loss {m2['loss'].item()} over the mesh, "
                                 f"{m1['loss'].item()} in one process")
        rec["loss_rel_err"] = loss_err
        rec["grad_norm_rel_err"] = abs(m2["grad_norm"].item() - m1["grad_norm"].item()) \
            / m1["grad_norm"].item()
        # held on the whole gradient, as 6d's classifier step: the ranks' GEMMs
        # at 2 rows round otherwise than one process's at 4, and a text-FFN
        # ReLU within a rounding step of 0 flips (the card read 3.2e-4 in
        # norm at layer 0's ffn_t W1 in fp32, 4.0e-6 for the whole gradient)
        rec["grads"] = grad_check(f"mesh step {tag}", dt, grads, ref_grads, whole=True)
        d2 = sum(((a - r).float().norm() ** 2).item() for a, r in zip(after, ref_after))
        u2 = sum(((r - b).float().norm() ** 2).item() for r, b in zip(ref_after, before))
        worst = max(((a - r).abs().max().item() for a, r in zip(after, ref_after)))
        rec["params"] = dict(update_rel_norm=math.sqrt(d2 / u2), max_abs=worst,
                             max_abs_over_lr=worst / MESH_LR)
        if not rec["params"]["update_rel_norm"] <= PARAM_TOL[dt]:
            raise AssertionError(f"mesh step {tag}: parameters after the step {rec['params']} "
                                 f"(limit {PARAM_TOL[dt]} in relative norm of the update)")
        print(f"  mesh step {tag} B={MESH_B}: {rec['mesh_ms']:.1f} ms over the mesh "
              f"(single process {rec['single_ms']:.1f} ms); loss rel err {loss_err:.3g}, "
              f"grad norm rel err {rec['grad_norm_rel_err']:.3g}, gradients {rec['grads']}, "
              f"parameters {rec['params']}; launches {launches}", flush=True)
    del model, state, step
    torch.cuda.empty_cache()
    return rec, launches


def mesh_serving(mesh, clips):
    """Phase 9d on this rank: its data block of phase 4's requests on the
    W8A8 and the bf16 trees at full width through the kernels, then every
    request's probabilities and beta gathered over the data group
    (``mesh.gather_rows``). Returns ``{tree: (probabilities by uid of every
    request, this rank's launches, seconds)}``."""
    from hriemo_torch.parallel import mesh as PM

    wavlm, bert, fusion = serving_models(torch.Generator().manual_seed(SEED + 3))
    kw = serving_kwargs()
    per = len(clips) // mesh.n_data
    mine = clips[mesh.data_rank * per:(mesh.data_rank + 1) * per]
    out = {}
    for tree, extra in (("int8", {}), ("bf16", dict(int8_frontends=False))):
        pipe = StreamingPipeline(wavlm, bert, fusion, **dict(kw, **extra))
        reset_launches()
        t = time.perf_counter()
        got, _ = serve(pipe, mine)
        launches = read_launches()
        probs, beta = (torch.from_numpy(np.stack([got[c[2]][i] for c in mine])).cuda()
                       for i in (0, 1))
        probs, beta = PM.gather_rows([probs, beta], mesh)
        if probs.shape[0] != len(clips) or not torch.isfinite(beta).all():
            raise AssertionError(f"mesh serving {tree}: gathered {tuple(probs.shape)} "
                                 f"probabilities for {len(clips)} requests")
        out[tree] = ({c[2]: p for c, p in zip(clips, probs.cpu().numpy())}, launches,
                     time.perf_counter() - t)
        del pipe
    return out


def mesh_ring(meshes):
    """Phase 9e: ring attention at one rank (the data mesh's model groups
    have one rank each) on the card against full softmax attention, bf16
    at ``ATTN_TOL``, element 1 with 311 padded keys."""
    from hriemo_torch.parallel.sequence_parallel import sp_self_attention

    gen = torch.Generator().manual_seed(SEED + 12)
    q, k, v = (torch.randn(*RING_SHAPE, generator=gen).to("cuda", torch.bfloat16)
               for _ in range(3))
    lk = RING_SHAPE[2]
    mask = (torch.arange(lk)[None, :] >= torch.tensor([lk, lk - 311])[:, None]).cuda()
    ring = sp_self_attention(meshes["dp"])
    got = ring(q, k, v, mask)
    ref = FA.onepass_attention_plain(q, k, v, FA.key_bias(mask, 2, lk, q.device))
    err, med = compare("ring attention (one rank)", got, ref, ATTN_TOL[torch.bfloat16])
    ms = cuda_event_ms(lambda: ring(q, k, v, mask))
    plain_ms = cuda_event_ms(lambda: FA.onepass_attention_plain(
        q, k, v, FA.key_bias(mask, 2, lk, q.device)))
    return dict(shape=list(RING_SHAPE), max_abs_err=err, median_err=med, ms=ms,
                full_attention_ms=plain_ms,
                across_ranks="waits for a card per rank: gloo takes no CUDA tensors "
                             "point to point")


def cuda_event_ms(fn, iters: int = 5) -> float:
    """Device ms of one call of ``fn`` by CUDA events over ``iters`` calls
    after one warm-up (host work between launches included)."""
    fn()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def mesh_rank(dev, clips):
    """One of phase 9's two ranks (both on the card): 9a and 9b, 9d over
    the data mesh, 9e on rank 0. Returns rank 0's readings and this
    rank's launches of the main-path runs (the mesh steps and serving)."""
    import torch.distributed as dist
    from hriemo_torch.parallel import mesh as PM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lead = dist.get_rank() == 0
    meshes = {k: PM.make_mesh(*s) for k, s in MESH_SHAPES.items()}
    total = dict.fromkeys(LAUNCH_NAMES, 0)
    rec = {"steps": {}}
    t = time.perf_counter()
    cases = [(kind, la, dt, 0.0) for kind in ("dp", "tp") for la in TRAIN_AUDIO
             for dt in (torch.float32, torch.bfloat16)]
    cases += [("dp", la, dt, 0.1) for la in TRAIN_AUDIO for dt in (torch.float32, torch.bfloat16)]
    for kind, la, dt, p in cases:
        r, ll = mesh_step_case(meshes, kind, la, dt, p, lead)
        rec["steps"][f"{kind} L={la} {str(dt)[6:]} dropout {p}"] = r
        for name, n in ll.items():
            total[name] += n
    rec["steps_s"] = time.perf_counter() - t
    t = time.perf_counter()
    served = mesh_serving(meshes["dp"], clips)
    for _, ll, _ in served.values():
        for name, n in ll.items():
            total[name] += n
    rec["serving"] = served
    rec["serving_s"] = time.perf_counter() - t
    if lead:
        t = time.perf_counter()
        rec["ring"] = mesh_ring(meshes)
        rec["ring_s"] = time.perf_counter() - t
    dist.barrier()
    return rec, total


def mesh_trainer_runs(smi, root: pathlib.Path):
    """Phase 9c: the MOSEI trainer at phase 6b's corpus and defaults with
    ``--n_data 1`` (one NCCL rank, the card its own) and ``--n_data 2``
    (two gloo ranks sharing it), each spawned by the CLI. The first must
    log phase 6b's losses bit for bit, the second within
    ``LOSS_RTOL[bf16]``."""
    mosei = root / "mosei"
    argv = ["--index_csv", str(mosei / "mosei_index_splits.csv"), "--audio_dir",
            str(mosei / "features" / "audio"), "--text_dir", str(mosei / "features" / "text"),
            "--epochs", "7"]

    def losses(out):
        with open(out / "outputs" / "train_log.csv", newline="") as f:
            return [(r["train_loss"], r["val_loss"]) for r in csv.DictReader(f)]
    ref = losses(root / "mosei_run")
    rec = {}
    for n_data in (1, 2):
        out = root / f"mosei_mesh_{n_data}"
        t = time.perf_counter()
        best = TRAIN_MOSEI.main(argv + ["--n_data", str(n_data), "--out_dir", str(out)])
        secs = time.perf_counter() - t
        got = losses(out)
        if n_data == 1 and got != ref:
            raise AssertionError(f"MOSEI trainer --n_data 1: losses {got} differ from phase "
                                 f"6b's {ref}")
        if n_data == 2 and not (len(got) == len(ref) and np.allclose(
                np.asarray(got, float), np.asarray(ref, float), rtol=LOSS_RTOL[torch.bfloat16])):
            raise AssertionError(f"MOSEI trainer --n_data 2: losses {got} against phase 6b's "
                                 f"{ref} (rtol {LOSS_RTOL[torch.bfloat16]})")
        gap = float(np.max(np.abs(np.asarray(got, float) / np.asarray(ref, float) - 1)))
        rec[f"n_data_{n_data}"] = dict(seconds=secs, best=best, max_rel_gap=gap, losses=got)
        print(f"MOSEI trainer --n_data {n_data} (6b's corpus and defaults, 7 epochs; {smi}): "
              f"{'bit-equal to' if gap == 0 else f'max relative gap {gap:.3g} from'} phase 6b's "
              f"losses; {secs:.1f} s wall with the ranks' start", flush=True)
    return rec


def mesh_phase(smi, root: pathlib.Path, clips, int8_ref, bf16_ref):
    """Phase 9. Returns its record and the launches of its main-path runs
    on both ranks."""
    from hriemo_torch.parallel.launch import spawn

    t = time.perf_counter()
    ranks = spawn(mesh_rank, 2, "cuda", clips, timeout=SPAWN_TIMEOUT)
    spawn_s = time.perf_counter() - t
    rec = ranks[0][0]
    total = {name: sum(r[1][name] for r in ranks) for name in LAUNCH_NAMES}
    forwards = {}
    for tree, ref in (("int8", int8_ref), ("bf16", bf16_ref)):
        delta = 0.0
        for rank, (rr, _) in enumerate(ranks):  # each rank holds every request
            probs, ll, secs = rr["serving"][tree]
            if sorted(probs) != sorted(ref):
                raise AssertionError(f"mesh serving {tree} rank {rank}: requests "
                                     f"{sorted(probs)}, phase 4 served {sorted(ref)}")
            delta = max(delta, max(float(np.abs(p - ref[u][0]).max()) for u, p in probs.items()))
            want = ({n: 2 * k for n, k in PER_FORWARD.items()} if tree == "int8"
                    else {n: k for per in PER_FORWARD_BF16.values() for n, k in per.items()})
            check_launches(f"mesh serving {tree} rank {rank}", ll, want)
        if not delta <= DP_SERVE_TOL:
            raise AssertionError(f"mesh serving {tree}: max |p - single-process p| {delta} > "
                                 f"{DP_SERVE_TOL}")
        forwards[tree] = delta
        print(f"mesh serving {tree} (16 requests, 8 a data rank, gathered over the data "
              f"group on both of its 2 ranks on one card; {smi}): max |prob - single-process "
              f"prob| {delta:.3g} (limit {DP_SERVE_TOL})", flush=True)
    rec["serving"] = {tree: dict(max_prob_delta=d) for tree, d in forwards.items()}
    ring = rec["ring"]
    print(f"ring attention at one rank {ring['shape']} bf16 ({smi}): max |err| "
          f"{ring['max_abs_err']:.4g}, median {ring['median_err']:.3g} (ATTN_TOL); {ring['ms']:.3f} "
          f"ms against full attention's {ring['full_attention_ms']:.3f} ms; across ranks: "
          f"{ring['across_ranks']}", flush=True)
    print(f"phase 9a/9b steps {rec['steps_s']:.1f} s, 9d serving {rec['serving_s']:.1f} s, "
          f"9e ring {rec['ring_s']:.1f} s; the two ranks {spawn_s:.1f} s wall with their start",
          flush=True)
    t = time.perf_counter()
    rec["trainer"] = mesh_trainer_runs(smi, root)
    rec["trainer_s"] = time.perf_counter() - t
    rec["spawn_s"] = spawn_s
    return rec, total


# phase 10: the serving bench's path. Graph replay against the eager forward
# at the 2.5 s and 10 s buckets on the W8A8 and the bf16 trees, bit for bit;
# three back-to-back flushes of one bucket (one graph, replayed while the
# previous flush's result waits to be read); then the bench's own functions
# at two buckets and on a short clip stream.
GRAPH_BUCKETS = (2.5, 10.0)
BENCH_REPEATS = 3
BENCH_CLIPS = 256


def graph_phase(smi, wavlm, bert, fusion):
    """Phase 10. Returns its record."""
    from hriemo_torch import bench
    from hriemo_torch.infer.streaming import MEASURED_BUCKET_BATCH

    t0 = time.perf_counter()
    rec = {}
    clips = requests(np.random.default_rng(SEED + 15))
    models = (wavlm, bert, fusion)
    for tree, int8 in (("int8", True), ("bf16", False)):
        graphed = bench.serving_pipeline(models, "cuda", int8=int8, buckets=GRAPH_BUCKETS)
        eager = bench.serving_pipeline(models, "cuda", int8=int8, buckets=GRAPH_BUCKETS,
                                       cuda_graphs=False)
        for sec in GRAPH_BUCKETS:
            mine = [c for c in clips if graphed._bucket_for([c[0]], 16000) == sec]
            waves, texts = [c[0] for c in mine], [c[1] for c in mine]
            want = eager.infer(waves, texts)
            for i in range(2):  # the replay right after the capture, then a later one
                got = graphed.infer(waves, texts)
                for what, g, w in zip(("probabilities", "beta"), got, want):
                    if g.shape != w.shape or not np.array_equal(g, w):
                        raise AssertionError(
                            f"graph replay {tree} {sec:g} s ({len(mine)} clips), replay {i}: "
                            f"{what} differ from the eager forward by "
                            f"{np.abs(g - w).max() if g.shape == w.shape else g.shape}")
            rec[f"replay_{tree}_{sec:g}s"] = dict(clips=len(mine), bit_equal=True)
        print(f"graph replay {tree}: probabilities and beta bit-equal to the eager forward at "
              f"{GRAPH_BUCKETS} s ({len(graphed._graphs)} graphs)", flush=True)
        del graphed, eager
    # three flushes of four 10 s clips, one text bucket: one graph, replayed
    # back to back, each flush's result read one flush later
    rng = np.random.default_rng(SEED + 16)
    words = np.array("happy sad angry neutral really very today fine so not".split())
    same = [((rng.standard_normal(int(rng.uniform(7.6, 10.0) * 16000)) * 3000).astype(np.int16),
             " ".join(rng.choice(words, 50)), f"b{i}") for i in range(12)]
    runs = {}
    for graphs in (True, False):
        pipe = bench.serving_pipeline(models, "cuda", buckets=GRAPH_BUCKETS, cuda_graphs=graphs)
        runs[graphs] = {u: (p, b) for ps, bs, us in pipe.stream_bucketed(
            same, bucket_batch={10.0: 4}, pad_flush=True) for u, p, b in zip(us, ps, bs)}
        if graphs and len(pipe._graphs) != 1:
            raise AssertionError(f"back-to-back flushes: {len(pipe._graphs)} graphs, one expected")
        del pipe
    for u, (p, b) in runs[False].items():
        if not (np.array_equal(runs[True][u][0], p) and np.array_equal(runs[True][u][1], b)):
            raise AssertionError(f"back-to-back flushes: {u}'s result differs from the eager "
                                 "forward's (a later replay overwrote it?)")
    rec["back_to_back"] = dict(flushes=3, bit_equal=True)
    print("three back-to-back flushes of the 10 s bucket through one graph: each bit-equal to "
          "the eager forward", flush=True)
    torch.cuda.empty_cache()

    # the bench's functions: two buckets at their measured batches, three
    # repeats; the scheduler on a stream of 256 clips over all 14 buckets
    pipe = bench.serving_pipeline(models, "cuda")
    rng = np.random.default_rng(SEED + 17)
    batches = {sec: MEASURED_BUCKET_BATCH[sec] for sec in GRAPH_BUCKETS}
    head = bench.headline(pipe, rng, GRAPH_BUCKETS, batches, repeats=BENCH_REPEATS)
    buckets = {str(sec): {k: v for k, v in st.items() if k != "ops"}
               for sec, st in head["stats"].items()}
    print(json.dumps({"bench_buckets": buckets, "card": smi}), flush=True)
    for sec, st in buckets.items():
        if not 0 < st["mfu"] <= 1:
            raise AssertionError(f"bench bucket {sec} s: mfu {st['mfu']} outside (0, 1]")
    sched = bench.bench_scheduler(pipe, head["stats"],
                                  clips=bench.scheduler_clips()[:BENCH_CLIPS])
    print(json.dumps({"bench_scheduler": {k: v for k, v in sched.items() if k != "note"},
                      "card": smi}), flush=True)
    del pipe
    torch.cuda.empty_cache()
    rec.update(bench_buckets=buckets, bench_scheduler=sched, seconds=time.perf_counter() - t0)
    print(f"phase 10: {rec['seconds']:.1f} s wall", flush=True)
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # plain fp32 products stay fp32
    torch.backends.cudnn.allow_tf32 = False
    OUT.mkdir(exist_ok=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    t = time.perf_counter()
    built = _cuda.build_all()
    build_s = time.perf_counter() - t
    print(f"build: {build_s:.1f} s wall ({', '.join(f'{k} {v:.1f} s' for k, v in built.items())})",
          flush=True)
    if "--outlier-sweep" in sys.argv[1:]:
        return outlier_sweep(smi)

    gen = torch.Generator().manual_seed(SEED)
    print("kernels vs plain versions:", flush=True)
    rows, limit_checks = check_kernels(gen)

    # the served and the extracted weights draw from generators of their own,
    # so that rows added to phase 3 do not change them
    wavlm, bert, fusion = serving_models(torch.Generator().manual_seed(SEED + 3))
    kw = serving_kwargs()
    clips = requests(np.random.default_rng(SEED))
    phases = {}

    # phase 4: the int8 serving path
    pipe = StreamingPipeline(wavlm, bert, fusion, **kw)
    plain = StreamingPipeline(wavlm, bert, fusion, use_kernels=False, **kw)
    serve(pipe, clips)  # first calls of each shape: cuDNN plans, allocator
    serve(plain, clips)
    reset_launches()
    got, secs = serve(pipe, clips)
    launches = read_launches()
    forwards = len(clips) // B
    print(f"int8: served {len(got)} requests in {forwards} forwards, {secs:.3f} s; "
          f"launches {launches}", flush=True)
    check_launches("int8 serving", launches, {n: k * forwards for n, k in PER_FORWARD.items()})
    core = AB.attention_core_int8.launches
    if core != launches["attention_block_int8"] + launches["mha_block_int8"]:
        raise AssertionError(f"int8 serving: the attention core launched {core} times, once "
                             "per attention sublayer expected")
    # launches per forward of each phase-3 row's shape: the 16 requests are
    # 8 in each of the two buckets, 2 forwards each
    shapes = {"attention_core_int8": AB.attention_core_int8.shapes,
              "int8_gemm": _cuda.int8_gemm.shapes}
    for r in rows:
        if "counter_key" in r:
            r["launches_per_forward"] = shapes[r["kernel"]][tuple(r["counter_key"])] / 2
            print(f"  {r['kernel']} {r['shape']}: {r['launches_per_forward']:g} launches per "
                  "forward", flush=True)
    print(f"int8: attention core {core} launches, int8 GEMM {_cuda.int8_gemm.launches}",
          flush=True)
    check_probs("int8 serving", got, clips)
    ref, plain_secs = serve(plain, clips)
    delta = prob_delta(got, ref, clips)
    beta_delta = float(np.max(np.abs(np.stack([got[c[2]][1] for c in clips])
                                     - np.stack([ref[c[2]][1] for c in clips]))))
    print(f"int8 kernel vs plain: max prob delta {delta:.3g} (gate {PROB_GATE}), "
          f"max beta delta {beta_delta:.3g}; plain served in {plain_secs:.3f} s", flush=True)
    if not delta <= PROB_GATE:
        raise AssertionError(f"int8: prob delta {delta} > {PROB_GATE}")
    profile(pipe, clips, "int8")
    phases["int8"] = dict(launches=launches, forwards=forwards, serve_s=secs,
                          plain_serve_s=plain_secs, prob_delta=delta, beta_delta=beta_delta)
    total = dict(launches)  # launches over every main-path run
    del pipe, plain

    # phase 4, the int8 tree at fp32 compute: int8 weights, fp32 activations
    kw32 = dict(kw, compute_dtype=torch.float32)
    pipe32 = StreamingPipeline(wavlm, bert, fusion, **kw32)
    plain32 = StreamingPipeline(wavlm, bert, fusion, use_kernels=False, **kw32)
    serve(pipe32, clips)
    serve(plain32, clips)
    reset_launches()
    got32, secs32 = serve(pipe32, clips)
    launches32 = read_launches()
    print(f"int8 at fp32: served {len(got32)} requests in {secs32:.3f} s; launches {launches32}",
          flush=True)
    check_launches("int8 at fp32 serving", launches32,
                   {n: k * forwards for n, k in PER_FORWARD.items()})
    check_probs("int8 at fp32 serving", got32, clips)
    ref32, plain32_secs = serve(plain32, clips)
    delta32 = prob_delta(got32, ref32, clips)
    print(f"int8 at fp32 kernel vs plain: max prob delta {delta32:.3g} (gate {PROB_GATE}); "
          f"max |int8 at fp32 - int8| probability {prob_delta(got32, got, clips):.3g}; "
          f"plain served in {plain32_secs:.3f} s", flush=True)
    if not delta32 <= PROB_GATE:
        raise AssertionError(f"int8 at fp32: prob delta {delta32} > {PROB_GATE}")
    phases["int8_fp32"] = dict(launches=launches32, serve_s=secs32, plain_serve_s=plain32_secs,
                               prob_delta=delta32, vs_int8=prob_delta(got32, got, clips))
    for name, n in launches32.items():
        total[name] += n
    del pipe32, plain32

    # phase 4b: the bf16 tree on the same requests
    kw16 = dict(kw, int8_frontends=False)
    pipe16 = StreamingPipeline(wavlm, bert, fusion, **kw16)
    plain16 = StreamingPipeline(wavlm, bert, fusion, use_kernels=False, **kw16)
    per_bucket = {}
    for c in clips:
        sec = pipe16._bucket_for([c[0]], 16000)
        per_bucket[sec] = per_bucket.get(sec, 0) + 1
    want = {}
    for sec, n in per_bucket.items():
        for name, k in PER_FORWARD_BF16[sec].items():
            want[name] = want.get(name, 0) + k * -(-n // B)
    reset_launches()
    got16, secs16 = serve(pipe16, clips)
    launches16 = read_launches()
    print(f"bf16: served {len(got16)} requests in {secs16:.3f} s; launches {launches16}",
          flush=True)
    check_launches("bf16 serving", launches16, want)
    check_probs("bf16 serving", got16, clips)
    ref16, plain16_secs = serve(plain16, clips)
    delta16 = prob_delta(got16, ref16, clips)
    int8_delta = prob_delta(got, got16, clips)
    print(f"bf16 kernel vs plain: max prob delta {delta16:.3g} (gate {PROB_GATE}); "
          f"plain served in {plain16_secs:.3f} s", flush=True)
    print(f"int8_prob_delta {int8_delta:.6f} (max |int8 - bf16| probability, kernels on "
          f"both; gate {PROB_GATE})", flush=True)
    if not delta16 <= PROB_GATE:
        raise AssertionError(f"bf16: prob delta {delta16} > {PROB_GATE}")
    if not int8_delta <= PROB_GATE:
        raise AssertionError(f"int8_prob_delta {int8_delta} > {PROB_GATE}")
    profile(pipe16, clips, "bf16")
    phases["bf16"] = dict(launches=launches16, serve_s=secs16, plain_serve_s=plain16_secs,
                          prob_delta=delta16, int8_prob_delta=int8_delta)
    for name, n in launches16.items():
        total[name] += n
    del pipe16, plain16

    # phase 4c: long clips on the bf16, int8 and fp32 trees, one forward per bucket
    long_kw = dict(kw, max_seconds=45.0, bucket_seconds=(10.0, 30.0))
    long_clips = long_requests(np.random.default_rng(SEED + 1))
    trees = (("bf16", dict(int8_frontends=False)), ("int8", dict(int8_frontends=True)),
             ("fp32", dict(int8_frontends=False, compute_dtype=torch.float32)),
             ("int8_fp32", dict(int8_frontends=True, compute_dtype=torch.float32)))
    for tree, extra in trees:
        pk = StreamingPipeline(wavlm, bert, fusion, **dict(long_kw, **extra))
        pp = StreamingPipeline(wavlm, bert, fusion, use_kernels=False, **dict(long_kw, **extra))
        for sec, pair in ((30.0, long_clips[:2]), (45.0, long_clips[2:])):
            if {pk._bucket_for([c[0]], 16000) for c in pair} != {sec}:
                raise AssertionError(f"long clips: not all in the {sec} s bucket")
            reset_launches()
            got_l, secs_l = serve(pk, pair, batch=2)
            ll = read_launches()
            # the int8 trees' other kernels run too; the float trees run none
            names = ("attention_block_int8", *PER_FORWARD_LONG[30.0], "streaming_attention") \
                if tree.startswith("int8") else KERNELS
            check_launches(f"{tree} {sec:g} s", {n: ll[n] for n in names},
                           PER_FORWARD_LONG[sec])
            check_probs(f"{tree} {sec:g} s", got_l, pair)
            ref_l, plain_l = serve(pp, pair, batch=2)
            d_l = prob_delta(got_l, ref_l, pair)
            print(f"long {tree} {sec:g} s: served in {secs_l:.3f} s (plain {plain_l:.3f} s), "
                  f"kernel vs plain max prob delta {d_l:.3g}; launches {ll}", flush=True)
            if not d_l <= PROB_GATE:
                raise AssertionError(f"long {tree} {sec:g} s: prob delta {d_l} > {PROB_GATE}")
            profile(pk, pair, f"long_{tree}_{sec:g}s", batch=2)
            phases[f"long_{tree}_{sec:g}s"] = dict(launches=ll, serve_s=secs_l,
                                                   plain_serve_s=plain_l, prob_delta=d_l)
            for name, n in ll.items():
                total[name] += n
        del pk, pp
        torch.cuda.empty_cache()
    # phase 4d: the int8 tree with the fusion model at d=768 in 4 heads of
    # 192 (a decoder trained at --n_heads 4), phase 4's 16 requests: the
    # fusion stack's MHA sublayers run their core on the wide tile instance
    fusion4 = FusionWithEmotionDecoder(d_model=768, num_emotions=4, n_heads=4,
                                       num_layers_fusion=2, num_layers_decoder=2,
                                       beta_hidden=256)
    fusion4.init_weights(torch.Generator().manual_seed(SEED + 13))
    pipe4 = StreamingPipeline(wavlm, bert, fusion4, **kw)
    plain4 = StreamingPipeline(wavlm, bert, fusion4, use_kernels=False, **kw)
    serve(pipe4, clips)
    reset_launches()
    got4, secs4 = serve(pipe4, clips)
    launches4 = read_launches()
    print(f"int8, fusion in 4 heads: served {len(got4)} requests in {secs4:.3f} s; launches "
          f"{launches4}", flush=True)
    check_launches("int8 serving, fusion in 4 heads", launches4,
                   {**{n: k * forwards for n, k in PER_FORWARD.items()},
                    "attention_core_int8 (wide tiles)": FUSION_MHA_PER_FORWARD * forwards})
    check_probs("int8 serving, fusion in 4 heads", got4, clips)
    ref4, plain4_secs = serve(plain4, clips)
    delta4 = prob_delta(got4, ref4, clips)
    print(f"int8, fusion in 4 heads, kernel vs plain: max prob delta {delta4:.3g} (gate "
          f"{PROB_GATE}); plain served in {plain4_secs:.3f} s", flush=True)
    if not delta4 <= PROB_GATE:
        raise AssertionError(f"int8, fusion in 4 heads: prob delta {delta4} > {PROB_GATE}")
    phases["int8_fusion_4_heads"] = dict(launches=launches4, serve_s=secs4,
                                         plain_serve_s=plain4_secs, prob_delta=delta4)
    for name, n in launches4.items():
        total[name] += n
    del pipe4, plain4, fusion4
    torch.cuda.empty_cache()

    work = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        # phase 5: the feature-extraction entry point
        phases["extract"], ll, (idx, wavlm5, bert5) = extraction(
            torch.Generator().manual_seed(SEED + 4), smi, work / "extract")
        for name, n in ll.items():
            total[name] += n
        # phase 6: training
        phases["train"], ll = training(torch.Generator().manual_seed(SEED + 5), smi,
                                       work / "train")
        for name, n in ll.items():
            total[name] += n
        # phase 6c: the WavLM core's gradient; 6d: the seq-level trainer and
        # the FusionClassifier step through the flash kernels; 6e: the
        # utter-level trainer, the baselines, the MOSEI trainer's resume
        t6 = time.perf_counter()
        gen6 = torch.Generator().manual_seed(SEED + 10)
        phases["train"]["wavlm_gradient"] = wavlm_gradient(gen6)
        phases["train_classifier"], ll = classifier_training(gen6, smi, work / "train")
        for name, n in ll.items():
            total[name] += n
        phases["train_rest"] = remaining_trainers(smi, work / "train")
        print(f"phases 6c-6e (new): {time.perf_counter() - t6:.1f} s wall", flush=True)
        # phase 7: evaluation and inference on phase 5's tree and phase 6's checkpoints
        t7 = time.perf_counter()
        phases["eval"], ll = evaluation(smi, work, idx, wavlm5, bert5)
        phases["eval"]["seconds"] = time.perf_counter() - t7
        print(f"phase 7: {phases['eval']['seconds']:.1f} s wall", flush=True)
        for name, n in ll.items():
            total[name] += n
        # phase 8: per-bucket kernel numerics, the int8 report with its
        # revert, the C++ feature loader
        t8 = time.perf_counter()
        rec8 = phases["numerics"] = {"kernel_numerics": kernel_numerics(smi)}
        rec8["int8_report"], ll = int8_report(smi)
        for name, n in ll.items():
            total[name] += n
        rec8["feature_loader"] = feature_loader(smi, work / "train")
        rec8["seconds"] = time.perf_counter() - t8
        print(f"phase 8: {rec8['seconds']:.1f} s wall", flush=True)
        # phase 9: the mesh on the one card, whose memory the ranks share
        torch.cuda.empty_cache()
        t9 = time.perf_counter()
        phases["mesh"], ll = mesh_phase(smi, work / "train", clips, got, got16)
        for name, n in ll.items():
            total[name] += n
        phases["mesh"]["seconds"] = time.perf_counter() - t9
        print(f"phase 9: {phases['mesh']['seconds']:.1f} s wall", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # phase 10: graph replay against eager, back-to-back flushes, the bench
    phases["bench"] = graph_phase(smi, wavlm, bert, fusion)
    for name, n in total.items():
        if n == 0:
            raise AssertionError(f"{name}: launched on no main path")

    kernels = []
    for name, (fn, replaces, source) in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name]
        # bf16, the default (the fp16 and head-dim-32 rows stand beside them)
        served = [r for r in mine if not r["shape"].endswith("float32")
                  and r.get("kernels_line", True)]
        main_row = max(served, key=lambda r: r["ms"])  # the costliest call on the paths
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=total[name],
                            max_abs_err=max(r["max_abs_err"] for r in mine),
                            ms=main_row["ms"], plain_ms=main_row["plain_ms"],
                            bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
                            library_ms=main_row["library_ms"], route_ms=main_row["route_ms"],
                            shape=main_row["shape"]))
    for name, (replaces, source) in WIDE_KERNELS.items():
        mine = [r for r in rows if r.get("wide_entry") == name]
        # bf16 (the int8 core's rows are bf16 and name no dtype)
        main_row = max((r for r in mine if r["shape"].split()[-1] not in ("float32", "float16")),
                       key=lambda r: r["ms"])
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=total[name],
                            max_abs_err=max(r["max_abs_err"] for r in mine),
                            ms=main_row["ms"], plain_ms=main_row["plain_ms"],
                            bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
                            library_ms=main_row["library_ms"], route_ms=main_row["route_ms"],
                            shape=main_row["shape"]))
    (OUT / "chip_smoke.json").write_text(json.dumps(dict(
        card=smi, build_s=build_s, rows=rows, limit_checks=limit_checks, launches=total,
        phases=phases, int8_prob_delta=int8_delta), indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
