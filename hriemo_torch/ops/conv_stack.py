"""WavLM feature-encoder conv stack (port of ``hriemo/ops/conv_stack.py``).

Two parts:

* :func:`group_norm_stats_from_waveform` (``:316-374``), plain PyTorch: in
  JAX this is XLA code, not a Pallas kernel. conv0 is linear in the
  waveform, so the per-channel moments of its output over time come from
  the 10x10 Gram matrix of the waveform's stride-5 phase view, and the
  routed feature encoder (``frontends/wavlm.py``) needs no pass over the
  conv0 activation for its GroupNorm.
* The fused stack (``:60-274``), three Hopper kernels of
  ``csrc/conv_stack.cu``, each with its plain PyTorch version and launch
  count, composed by :func:`conv_stack_fused`:

  - :func:`conv_stack_stats` replaces ``_stats_kernel`` (``pallas_call`` at
    ``:228``): per-channel sum and sum of squares of conv0 over its valid
    rows, ``[B, 2, C]`` fp32; on the card fp32 partial sums over chunks of
    :data:`STATS_ROWS` rows (in bf16 conv0 on the tensor cores, the phase
    view's rows against w0 padded to 16 taps, as the TPU kernel's ``_gemm``),
    added in chunk order by a second launch, so that the sums have the same
    bits on every run;
  - :func:`conv_stack_k1` replaces ``_k1_kernel`` (``:243``): conv0,
    GroupNorm from those sums (``var = s2/n - mean^2``, no clamp, unlike
    the Gram route), GELU, conv1..3, ``[B, t3, C]``; on the card conv0 is
    one pass and each of conv1..3 one GEMM over :func:`conv_rows`, the
    strided view of its input (in bf16 :func:`conv_gemm`, the TMA GEMM of
    ``csrc/tma_gemm.cuh``);
  - :func:`conv_stack_k2` replaces ``_k2_kernel`` (``:263``): conv4..6,
    ``[B, t_out, C]``, on the card one such GEMM each.

  Rounding points are the TPU kernels': fp32 sums, GroupNorm and GELU (the
  config's tanh or erf) in fp32, each conv's output cast to the input dtype
  before the next conv, conv0's output normalised before any rounding. It
  is forward-only, like the TPU kernels.

The JAX package routes the stack off, after a TPU's readings; the port
routes the served encoder by the H100's (:func:`conv_stack_route`,
:func:`use_conv_stack`): every bf16 waveform on the card takes the
kernels, fp32 and the CPU take the cuDNN route of ``frontends/wavlm.py``.

Stage operands: the waveform ``[B, Tw]`` and weights in its dtype, conv0's
weight as ``[C, 10]``, conv1..6 tap-major ``[K, C_out, C_in]``
(:func:`conv_taps`), GroupNorm parameters and statistics in fp32.
"""

from __future__ import annotations

import collections

import torch

from . import _cuda
from .fused_ffn import gelu_fp32

KERNEL = (10, 3, 3, 3, 3, 2, 2)   # the base feature encoder's conv pattern
STRIDE = (5, 2, 2, 2, 2, 2, 2)
CHANNELS = 512                    # the kernels' width (csrc/conv_stack.cu kC)
STATS_ROWS = 256                  # conv0 rows of a stats chunk (csrc/conv_stack.cu kStatsRows)


def _gram_phase_views(wave):
    """``[B, Tw]`` -> ``(A, Ar)``, ``[B, T0, 5]`` fp32: together the conv0
    receptive field ``[5t, 5t + 10)`` of output frame t."""
    b, tw = wave.shape
    t0 = (tw - 10) // 5 + 1
    need = 5 * t0 + 5
    wave = torch.nn.functional.pad(wave.float(), (0, max(0, need - tw)))
    a = wave[:, :5 * t0].reshape(b, t0, 5)
    ar = wave[:, 5:5 * t0 + 5].reshape(b, t0, 5)
    return a, ar


def group_norm_stats_from_waveform(wave, conv0_weight):
    """Per-channel (mean, var) ``[B, C]`` fp32 of conv0's output, without
    running conv0. ``conv0_weight``: torch layout ``[C, 1, 10]``."""
    a, ar = _gram_phase_views(wave)
    n = a.shape[1]
    w = conv0_weight[:, 0, :].float().t()                  # [10, C]
    w1, w2 = w[:5], w[5:]
    mean = (a.sum(dim=1) @ w1 + ar.sum(dim=1) @ w2) / n   # [B, C]
    gaa = torch.einsum("bti,btj->bij", a, a)
    gar = torch.einsum("bti,btj->bij", a, ar)
    grr = torch.einsum("bti,btj->bij", ar, ar)
    ex2 = (torch.einsum("bij,ic,jc->bc", gaa, w1, w1)
           + 2.0 * torch.einsum("bij,ic,jc->bc", gar, w1, w2)
           + torch.einsum("bij,ic,jc->bc", grr, w2, w2)) / n
    # E[x^2] - mean^2 cancels for near-constant conv0 outputs (silence);
    # clamp so rstd never sees a tiny negative variance
    return mean, torch.clamp_min(ex2 - mean * mean, 0.0)


def conv_lengths(tw: int) -> list[int]:
    """True output lengths of conv0..6 for a ``tw``-sample waveform."""
    lens = [(tw - KERNEL[0]) // STRIDE[0] + 1]
    for k, s in zip(KERNEL[1:], STRIDE[1:]):
        lens.append((lens[-1] - k) // s + 1)
    return lens


def conv_taps(weight, dtype):
    """torch Conv1d weight ``[C_out, C_in, K]`` -> tap-major ``[K, C_out,
    C_in]`` contiguous in ``dtype``, the kernels' weight layout."""
    return weight.detach().to(dtype).permute(2, 0, 1).contiguous()


def conv_rows(x, k: int):
    """The rows of a stride-2 conv with ``k`` taps over ``x [B, T, C]``
    (contiguous) as one GEMM operand, with no copy: ``[B, t_out, k*C]``,
    where row r of batch element b is ``x[b, 2r : 2r + k]`` flattened, its
    ``k*C`` elements contiguous and rows ``2C`` apart (tap j at K-offset
    ``j*C``). The card's convs (K1's and K2's) read exactly this view."""
    b, t, c = x.shape
    return x.as_strided((b, (t - k) // 2 + 1, k * c), (t * c, 2 * c, 1), x.storage_offset())


# ---------------------------------------------------------------- plain

def _conv0(wave, w0):
    """conv0 without bias, fp32 sums: ``[B, n0, C]``. ``w0 [C, 10]``."""
    return wave.unfold(1, 10, 5).float() @ w0.float().t()


def _conv_s2(x, taps, fast_gelu):
    """gelu(stride-2 conv) over ``x [B, T, C]``, fp32 sums of the taps in
    order, rounded to x's dtype."""
    k = taps.shape[0]
    t = (x.shape[1] - k) // 2 + 1
    acc = None
    for j in range(k):
        part = x[:, j:j + 2 * (t - 1) + 1:2].float() @ taps[j].float().t()
        acc = part if acc is None else acc + part
    return gelu_fp32(acc, fast_gelu).to(x.dtype)


def conv_stack_stats_plain(wave, w0):
    """Plain PyTorch version of :func:`conv_stack_stats`."""
    x0 = _conv0(wave, w0)
    return torch.stack([x0.sum(dim=1), (x0 * x0).sum(dim=1)], dim=1)


def _conv0_gn(wave, stats, w0, gn_w, gn_b, eps: float, fast_gelu: bool):
    """K1's first stage: conv0, GroupNorm from ``stats`` and GELU, rounded
    to the waveform's dtype, ``[B, n0, C]``."""
    x0 = _conv0(wave, w0)
    inv_n = 1.0 / x0.shape[1]
    mean = stats[:, 0:1] * inv_n                      # [B, 1, C]
    var = stats[:, 1:2] * inv_n - mean * mean
    rstd = torch.rsqrt(var + eps)
    return gelu_fp32((x0 - mean) * rstd * gn_w.float() + gn_b.float(), fast_gelu).to(wave.dtype)


def conv_stack_k1_plain(wave, stats, w0, gn_w, gn_b, w1, w2, w3, eps: float, fast_gelu: bool):
    """Plain PyTorch version of :func:`conv_stack_k1`."""
    x = _conv0_gn(wave, stats, w0, gn_w, gn_b, eps, fast_gelu)
    for taps in (w1, w2, w3):
        x = _conv_s2(x, taps, fast_gelu)
    return x


def conv_stack_k2_plain(x3, w4, w5, w6, fast_gelu: bool):
    """Plain PyTorch version of :func:`conv_stack_k2`."""
    x = x3
    for taps in (w4, w5, w6):
        x = _conv_s2(x, taps, fast_gelu)
    return x


# --------------------------------------------------------------- kernels

def _check_wave(wave, what):
    if wave.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what}: dtype {wave.dtype}, needs bf16 or fp32")
    if wave.dim() != 2:
        raise ValueError(f"{what}: waveform must be [B, Tw], got {tuple(wave.shape)}")
    _cuda.require(wave, "wave", wave.dtype)


def _check_taps(taps, k, dtype, dev, name):
    _cuda.require(taps, name, dtype, (k, CHANNELS, CHANNELS), dev)


def conv_gemm(x, taps, fast_gelu: bool, bn: int | None = None):
    """gelu(stride-2 conv) of ``x [B, T, C]`` bf16 with ``taps [k, C, C]``
    (k 2 or 3): ``[B, (T - k) // 2 + 1, C]`` bf16, one launch of the TMA
    GEMM (csrc/conv_stack.cu ``hr_conv_s2_tma``) over x's even and odd rows
    as two tensor maps, on the plan of ``_cuda.tma_gemm_plan`` (``bn``
    forces its column tile). The plain version is ``_conv_s2``, which the
    CPU takes. ``conv_gemm.launches`` counts launches."""
    if x.device.type == "cpu":
        return _conv_s2(x, taps, fast_gelu)
    return _conv_gemm_into(x, taps, fast_gelu, None, bn)


conv_gemm.launches = 0


def _conv_gemm_into(x, taps, fast_gelu, out, bn=None):
    """:func:`conv_gemm`'s launch on the card into ``out [B, M, C]`` bf16, or
    into a new tensor where ``out`` is None; returns it."""
    b, t, _ = x.shape
    k = taps.shape[0]
    _cuda.require(x, "x", torch.bfloat16, (b, t, CHANNELS))
    _check_taps(taps, k, torch.bfloat16, x.device, "taps")
    if k not in (2, 3) or t < k:
        raise ValueError(f"conv_gemm: {k} taps over {t} rows")
    m = (t - k) // 2 + 1
    bn, grid = _cuda.tma_gemm_plan(b, m, CHANNELS, _cuda.sm_count(), bn)
    if out is None:
        out = torch.empty((b, m, CHANNELS), dtype=x.dtype, device=x.device)
    _cuda.require(out, "out", torch.bfloat16, (b, m, CHANNELS), x.device)
    _cuda.check(_cuda.lib("conv_stack").hr_conv_s2_tma(
        x.data_ptr(), b, t, k, taps.data_ptr(), m, int(fast_gelu), bn, grid, out.data_ptr(),
        _cuda.stream()), "hr_conv_s2_tma")
    conv_gemm.launches += 1
    return out


def _conv_launches(x, taps_seq, fast_gelu, cp_async: bool = False):
    """gelu(stride-2 conv) for each of ``taps_seq`` in turn, from ``x [B, T,
    C]`` on the card: one GEMM launch each over :func:`conv_rows` of the
    previous output, into a new tensor from the caching allocator. bf16
    takes :func:`conv_gemm`, fp32 the 3xTF32 GEMM of csrc/float_wgmma.cuh
    (``hr_conv_s2``); ``cp_async`` puts bf16 there too, as the yardstick
    that the TMA GEMM is timed beside."""
    lib, fp32 = _cuda.lib("conv_stack"), int(x.dtype == torch.float32)
    for taps in taps_seq:
        if not (fp32 or cp_async):
            x = _conv_gemm_into(x, taps, fast_gelu, None)
            continue
        rows = conv_rows(x, taps.shape[0])
        x = torch.empty((x.shape[0], rows.shape[1], CHANNELS), dtype=x.dtype, device=x.device)
        _cuda.check(lib.hr_conv_s2(
            fp32, rows.data_ptr(), rows.stride(0), rows.stride(1), rows.shape[2],
            taps.data_ptr(), x.shape[0], rows.shape[1], int(fast_gelu), x.data_ptr(),
            _cuda.stream()), "hr_conv_s2")
    return x


def _conv0_launch(wave, stats, w0, gn_w, gn_b, eps: float, fast_gelu: bool):
    """K1's first launch on the card: conv0, GroupNorm and GELU into a new
    ``[B, n0, C]`` tensor in the waveform's dtype (checked by the caller)."""
    b, tw = wave.shape
    n0 = conv_lengths(tw)[0]
    x0 = torch.empty((b, n0, CHANNELS), dtype=wave.dtype, device=wave.device)
    _cuda.check(_cuda.lib("conv_stack").hr_conv0_gn(
        int(wave.dtype == torch.float32), wave.data_ptr(), b, tw, stats.data_ptr(),
        w0.data_ptr(), gn_w.data_ptr(), gn_b.data_ptr(), 1.0 / n0, eps, int(fast_gelu), n0,
        x0.data_ptr(), _cuda.stream()), "hr_conv0_gn")
    return x0


def conv_stack_stats(wave, w0):
    """Sum and sum of squares over time of conv0 ``[B, 2, C]`` fp32, over
    its ``(Tw - 10) // 5 + 1`` valid rows. ``wave [B, Tw]`` bf16 or fp32;
    ``w0 [C, 10]`` in the waveform's dtype. On the card bf16 takes conv0 on
    the tensor cores (``conv_stats_mma_kernel``), fp32 on CUDA cores."""
    if wave.device.type == "cpu":
        return conv_stack_stats_plain(wave, w0)
    out = _stats_launch(wave, w0)
    conv_stack_stats.launches += 1
    return out


def _stats_launch(wave, w0, cuda_cores: bool = False):
    """:func:`conv_stack_stats`'s two launches on the card (uncounted);
    ``cuda_cores`` runs bf16's first level on the CUDA-core kernel, the
    yardstick that the tensor-core one is timed beside."""
    _check_wave(wave, "conv_stack_stats")
    b, tw = wave.shape
    n0 = conv_lengths(tw)[0]
    if n0 < 1:
        raise ValueError(f"conv_stack_stats: {tw} samples give no conv0 row")
    _cuda.require(w0, "w0", wave.dtype, (CHANNELS, 10), wave.device)
    chunks = -(-n0 // STATS_ROWS)
    part = torch.empty((b, chunks, 2, CHANNELS), dtype=torch.float32, device=wave.device)
    out = torch.empty((b, 2, CHANNELS), dtype=torch.float32, device=wave.device)
    _cuda.check(_cuda.lib("conv_stack").hr_conv_stats(
        int(wave.dtype == torch.float32), wave.data_ptr(), b, tw, w0.data_ptr(), n0, chunks,
        part.data_ptr(), out.data_ptr(), int(cuda_cores), _cuda.stream()), "hr_conv_stats")
    return out


conv_stack_stats.launches = 0


def conv_stack_k1(wave, stats, w0, gn_w, gn_b, w1, w2, w3, eps: float, fast_gelu: bool):
    """conv0, GroupNorm (from ``stats``, :func:`conv_stack_stats`), GELU and
    conv1..3 (taps ``[3, C, C]``): ``[B, t3, C]`` in the waveform's dtype.
    On the card four launches: conv0 into a ``[B, n0, C]`` workspace, then
    each conv one GEMM over :func:`conv_rows` of the previous output (in
    bf16 :func:`conv_gemm`)."""
    if wave.device.type == "cpu":
        return conv_stack_k1_plain(wave, stats, w0, gn_w, gn_b, w1, w2, w3, eps, fast_gelu)
    _check_wave(wave, "conv_stack_k1")
    b, tw = wave.shape
    lens = conv_lengths(tw)
    if lens[3] < 1:
        raise ValueError(f"conv_stack_k1: {tw} samples give no conv3 frame")
    dt, dev = wave.dtype, wave.device
    _cuda.require(stats, "stats", torch.float32, (b, 2, CHANNELS), dev)
    _cuda.require(w0, "w0", dt, (CHANNELS, 10), dev)
    _cuda.require(gn_w, "gn_w", torch.float32, (CHANNELS,), dev)
    _cuda.require(gn_b, "gn_b", torch.float32, (CHANNELS,), dev)
    for taps, name in ((w1, "w1"), (w2, "w2"), (w3, "w3")):
        _check_taps(taps, 3, dt, dev, name)
    x = _conv_launches(_conv0_launch(wave, stats, w0, gn_w, gn_b, eps, fast_gelu),
                       (w1, w2, w3), fast_gelu)
    conv_stack_k1.launches += 1
    return x


conv_stack_k1.launches = 0


def conv_stack_k2(x3, w4, w5, w6, fast_gelu: bool):
    """conv4 (taps ``[3, C, C]``), conv5 and conv6 (``[2, C, C]``) over the
    conv3 rows ``x3 [B, t3, C]``: ``[B, t_out, C]`` in x3's dtype. On the
    card three GEMM launches over :func:`conv_rows`, as K1's convs."""
    if x3.device.type == "cpu":
        return conv_stack_k2_plain(x3, w4, w5, w6, fast_gelu)
    dt, dev = x3.dtype, x3.device
    if dt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"conv_stack_k2: dtype {dt}, needs bf16 or fp32")
    b, t3 = x3.shape[:2]
    _cuda.require(x3, "x3", dt, (b, t3, CHANNELS), dev)
    t_out = t3
    for k in KERNEL[4:]:
        t_out = (t_out - k) // 2 + 1
    if t_out < 1:
        raise ValueError(f"conv_stack_k2: {t3} conv3 rows give no output frame")
    _check_taps(w4, 3, dt, dev, "w4")
    _check_taps(w5, 2, dt, dev, "w5")
    _check_taps(w6, 2, dt, dev, "w6")
    out = _conv_launches(x3, (w4, w5, w6), fast_gelu)
    conv_stack_k2.launches += 1
    return out


conv_stack_k2.launches = 0


def stack_operands(feature_extractor, dtype):
    """The stages' weights from a port WavLM ``feature_extractor`` (torch
    layout ``[O, I, K]``): ``(w0 [C, 10], gn_w, gn_b, taps1..taps6)``."""
    layers = feature_extractor.conv_layers
    w0 = layers[0].conv.weight.detach()[:, 0, :].to(dtype).contiguous()
    gn = layers[0].layer_norm
    return (w0, gn.weight.detach().float().contiguous(), gn.bias.detach().float().contiguous(),
            *(conv_taps(layers[i].conv.weight, dtype) for i in range(1, 7)))


def prepared_operands(feature_extractor, dtype):
    """:func:`stack_operands` taken once and kept on ``feature_extractor``
    (``stack_ops``), so that a forward, and a CUDA graph's replay, makes no
    copy of the weights. They are taken again when a weight changes (another
    tensor, or an in-place write, which moves its version counter) or for
    another dtype; a graph captured before must then be captured again, as
    for every operand ``quantize_for_serving`` derives."""
    layers = feature_extractor.conv_layers
    gn = layers[0].layer_norm
    weights = [layer.conv.weight for layer in layers] + [gn.weight, gn.bias]
    try:
        key = (dtype, *((id(w), w.data_ptr(), w._version) for w in weights))
    except RuntimeError:  # inference tensors keep no version counter: nothing to key on
        return stack_operands(feature_extractor, dtype)
    kept = getattr(feature_extractor, "stack_ops", None)
    if kept is None or kept[0] != key:
        feature_extractor.stack_ops = kept = (key, stack_operands(feature_extractor, dtype))
    return kept[1]


def base_pattern(cfg) -> bool:
    """The stack's encoder: the base 7-layer conv pattern, equal widths, no
    conv bias (the card's kernels also need :data:`CHANNELS`)."""
    return (tuple(cfg.conv_kernel) == KERNEL and tuple(cfg.conv_stride) == STRIDE
            and not cfg.conv_bias and len(set(cfg.conv_dim)) == 1)


def conv_stack_fused(feature_extractor, wave, cfg, use_kernels: bool = True):
    """Full WavLM feature encoder: ``wave [B, Tw]`` -> ``[B, t_out, C]`` in
    the waveform's dtype (``hriemo/ops/conv_stack.py::conv_stack_fused``).
    ``cfg`` must have the base 7-layer pattern without conv bias;
    ``use_kernels=False`` runs the three plain versions. The weights come
    from :func:`prepared_operands`."""
    if not base_pattern(cfg):
        raise ValueError("conv_stack_fused: needs the base 7-layer conv pattern, "
                         "equal widths and no conv bias")
    w0, gn_w, gn_b, *taps = prepared_operands(feature_extractor, wave.dtype)
    stats_fn, k1, k2 = ((conv_stack_stats, conv_stack_k1, conv_stack_k2) if use_kernels else
                        (conv_stack_stats_plain, conv_stack_k1_plain, conv_stack_k2_plain))
    x3 = k1(wave, stats_fn(wave, w0), w0, gn_w, gn_b, *taps[:3], cfg.layer_norm_eps,
            cfg.fast_gelu)
    return k2(x3, *taps[3:], cfg.fast_gelu)


def conv_stack_route(device_type: str, dtype, b: int, tw: int) -> str:
    """The feature encoder's route for a ``[b, tw]`` waveform of ``dtype``
    on a device of ``device_type``: "fused" (:func:`conv_stack_fused`) where
    the card's readings show stats + K1 + K2 faster than the cuDNN route,
    else "cudnn". On an NVIDIA H100 80GB HBM3 at 700 W (``python3
    chip_conv_routes.py``, PERF.md section 5) they are in bf16 at every
    shape read: 4.65-4.92x less time at the 14 served (bucket, batch) pairs,
    2.66x at the thinnest grid (B=1, 3.75 s), each of the three launches
    faster than its counterpart alone; so no shape bound. The CPU takes the
    cuDNN route's code, as the JAX package does off its TPU; fp32 stays
    there too (its 3xTF32 stack is held to 2e-4/2e-3 of the route, its
    extraction gate is 1e-4); so does a waveform too short for one output
    frame, which the kernels refuse."""
    if device_type != "cuda" or dtype != torch.bfloat16 or b < 1 or conv_lengths(tw)[6] < 1:
        return "cudnn"
    return "fused"


def use_conv_stack(cfg, feature_extractor, wave) -> bool:
    """Routing of the feature encoder to :func:`conv_stack_fused`: the base
    pattern at the kernels' width (:data:`CHANNELS`) and
    :func:`conv_stack_route`. It replaces the JAX package's gate, which is
    off because the fused Pallas stack lost the whole-model comparison on a
    TPU v5e (``hriemo/ops/conv_stack.py:277-313``): a measurement of that
    chip, not a semantic of the model. ``use_conv_stack.routes`` counts the
    decisions by (route, B, Tw, dtype)."""
    b, tw = wave.shape
    route = (conv_stack_route(wave.device.type, wave.dtype, b, tw)
             if base_pattern(cfg) and cfg.conv_dim[0] == CHANNELS else "cudnn")
    use_conv_stack.routes[route, b, tw, str(wave.dtype)[6:]] += 1
    return route == "fused"


use_conv_stack.routes = collections.Counter()
