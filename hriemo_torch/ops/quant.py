"""int8 serving quantization, W8A8 (port of ``hriemo/ops/quant.py``).

* :func:`quantize_linear_params`: one-time symmetric per-output-channel
  weight quantization of a torch-layout ``[out, in]`` weight.
* :func:`int8_linear`: dynamic per-row activation quantization, an exact
  int8 x int8 -> int32 product, and an fp32 dequant epilogue. On the card it
  runs through the port's own int8 GEMM (``csrc/int8_gemm.cuh``).
* :func:`quantize_for_serving`: the ``quantize_tree_for_serving`` rule on a
  module tree. Every Linear with both dims >= ``min_dim`` and every packed
  MHA ``in_proj`` becomes int8; nothing under ``embeddings`` or
  ``rel_attn_embed`` is touched. Quantize after the bf16 cast, as the
  serving pipeline does: the int8 weights and scales are then bit-equal to
  the JAX package's. ``exclude`` keeps named layers in full precision.
* :func:`int8_numerics_report`: per-layer activation statistics, output
  deltas against the float module, and the greedy selective revert of the
  worst outlier layers (``hriemo/ops/quant.py:230-427``), with
  :func:`collect_activation_amax`, :func:`quantized_layer_names` and
  :func:`quantized_layer_paths`.

Both scale formulas of the reference are kept where they are used: this
module's ``max(amax, eps) / 127`` and the kernels' ``max(amax, eps) * (1/127)``
(``ops/fused_ffn.quant_rows``); they can differ by one ulp.
"""

from __future__ import annotations

import collections
import contextlib
import copy

import numpy as np
import torch

from . import _cuda

# Quantizing a Linear only pays when the GEMM is big; tiny projections (e.g.
# WavLM's 8-wide gate head) stay in the compute dtype.
DEFAULT_MIN_DIM = 256
SKIP = ("embeddings", "rel_attn_embed")

# The active activation-amax collector (collect_activation_amax); None in
# production.
_AMAX_COLLECTOR = None


def _div127(m: torch.Tensor) -> torch.Tensor:
    """``m / 127`` as an IEEE division on every device. PyTorch's CUDA
    kernels turn a division by a Python scalar into a multiply by its
    fp32 reciprocal, which is one ulp off for some ``m``; a tensor divisor
    keeps the true division of the JAX package (``quant.py:63,77``)."""
    return m / m.new_full((), 127.0)


def quantize_rowwise(x: torch.Tensor, eps: float = 1e-8):
    """Symmetric per-row int8 quantization over the last axis.

    Returns ``(q int8, scale fp32 [..., 1])`` with ``q * scale ~= x``;
    ``torch.round`` rounds half to even, as ``jnp.round`` does.
    """
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = _div127(amax.clamp_min(eps))
    q = torch.round(xf / scale).clamp_(-127, 127)
    return q.to(torch.int8), scale


def quantize_linear_params(weight: torch.Tensor, eps: float = 1e-8):
    """``[out, in]`` weight -> ``(w_int8 [out, in], w_scale [out, 1] fp32)``."""
    w = weight.detach().float()
    amax = w.abs().amax(dim=1, keepdim=True)
    scale = _div127(amax.clamp_min(eps))
    q = torch.round(w / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale


def int8_matmul_exact(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a [M, K] int8 . w [N, K]^T int8`` as fp32, exact up to the final
    int32 -> fp32 rounding: the product runs in float64, where every
    partial sum (at most 3072 * 127^2 < 2^53) is an exact integer."""
    return (a.double() @ w.double().t()).float()


def int8_linear_plain(x, w_int8, w_scale, bias=None):
    """Plain PyTorch version of :func:`int8_linear` (same arguments)."""
    shape = x.shape
    xq, xs = quantize_rowwise(x.reshape(-1, shape[-1]))
    if _AMAX_COLLECTOR is not None:
        _AMAX_COLLECTOR.record(w_int8, xs, x)
    y = int8_matmul_exact(xq, w_int8) * xs * w_scale[:, 0]
    if bias is not None:
        y = y + bias
    return y.to(x.dtype).reshape(*shape[:-1], w_int8.shape[0])


def int8_linear(x, w_int8, w_scale, bias=None, route: str | None = None):
    """``x @ W^T + b`` with W pre-quantized (``[out, in]`` int8, ``[out, 1]``
    fp32 scales) and x quantized per row on the fly; ``bias`` fp32 or None.

    Replaces no Pallas kernel: in JAX this is XLA's int8 ``dot_general``
    (``hriemo/ops/quant.py:85``). On the card, route "fused" is one launch
    of the projection that quantizes its own rows (``csrc/proj_int8.cu``:
    a thread-block cluster spans the output columns of 64 rows, x's rows are
    quantized once into each block's shared memory), "chain" a row-quantize
    launch and the shared int8 GEMM (``csrc/int8_gemm.cuh``); both apply
    the dequant and bias and store x's dtype (bf16 or fp32, as the JAX
    function returns ``x.dtype``), bit-equal to each other. None lets
    ``_cuda.proj_route`` choose by rows; a width no cluster spans takes the
    chain. It is bound by the weight bytes at the decoder's few rows and by
    int8 tensor-core operations at WavLM's feature projection.
    ``.shapes`` counts calls by (M, N, K), ``.routes`` by (route, M, N, K,
    x's element bytes).
    """
    if x.device.type == "cpu":
        return int8_linear_plain(x, w_int8, w_scale, bias)
    shape = x.shape
    n, k = w_int8.shape
    x2 = x.reshape(-1, k)
    _cuda.require(x2, "x", _cuda.ACT_DTYPES)
    _cuda.require(w_int8, "w_int8", torch.int8, (n, k), x.device)
    _cuda.require(w_scale, "w_scale", torch.float32, (n, 1), x.device)
    if bias is not None:
        _cuda.require(bias, "bias", torch.float32, (n,), x.device)
    m, epi = x2.shape[0], _cuda.out_epi(x.dtype)
    if route is None:
        route = _cuda.proj_route(n, m, k, x.element_size(), _cuda.sm_count())
    if route == "fused":
        y = _cuda.proj_gemm(x2, w_int8, w_scale, bias, epi, div127=True)
    elif route == "chain":
        xq, xs = _cuda.rowquant(x2, div127=True)
        y = _cuda.int8_gemm(xq, xs, w_int8, w_scale, bias, epi)
    else:
        raise ValueError(f"int8_linear: unknown route {route!r}")
    int8_linear.launches += 1
    int8_linear.shapes[m, n, k] += 1
    int8_linear.routes[route, m, n, k, x.element_size()] += 1
    return y.reshape(*shape[:-1], n)


int8_linear.launches = 0
int8_linear.shapes = collections.Counter()  # calls by (M, N, K)
int8_linear.routes = collections.Counter()  # calls by (route, M, N, K, x bytes)


def _excluded(name: str, exclude) -> bool:
    """True when ``name`` (dotted) or one of its ancestors is in ``exclude``
    ("a/b/c" paths, as the JAX package names tree nodes)."""
    parts = name.split(".") if name else []
    return any("/".join(parts[:i]) in exclude for i in range(1, len(parts) + 1))


def quantize_for_serving(module: torch.nn.Module, min_dim: int = DEFAULT_MIN_DIM,
                         skip=SKIP, exclude=frozenset(),
                         fuse_blocks: bool = True) -> torch.nn.Module:
    """Quantize ``module`` in place by the ``quantize_tree_for_serving`` rule
    and derive every kernel's operands. Returns ``module``.

    ``exclude``: "a/b/c" paths (module names with ``/`` for ``.``, which are
    the JAX tree's node paths) kept in full precision with everything under
    them: the selective revert of :func:`int8_numerics_report`. A block
    whose Linears are int8 only in part runs per op.

    Modules that can be quantized define ``quantize_(min_dim)``; modules
    that hand operands to a kernel define ``prepare_kernels(fuse_blocks)``,
    which runs once all weights are int8. ``fuse_blocks=False`` derives no
    fused-block operands, so every int8 Linear runs alone through
    :func:`int8_linear`: the route the JAX package takes off the TPU. Move
    the module to its device first: the derived operands are plain tensors
    that ``.to()`` does not move.
    """
    mods = [(name, m) for name, m in module.named_modules()
            if not any(s in name.split(".") for s in skip) and not _excluded(name, exclude)]
    for _, m in mods:
        if hasattr(m, "quantize_"):
            m.quantize_(min_dim)
    for _, m in module.named_modules():
        if hasattr(m, "prepare_kernels"):
            m.prepare_kernels(fuse_blocks)
    return module


def count_quantized(module: torch.nn.Module) -> int:
    """Number of int8 Linears and packed MHA in_projs in ``module``."""
    return sum(getattr(m, "w_int8", None) is not None
               or getattr(m, "in_proj_w_int8", None) is not None
               for m in module.modules())


# ---------------------------------------------------------------------------
# int8 numerics report and outlier mitigation (hriemo/ops/quant.py:230-427)
#
# A few high-magnitude activation channels inflate a row's dynamic scale and
# crush the resolution of every other channel in that row. The report gives
# per-layer activation statistics and a measured mitigation: the worst
# layers go back to full precision, one at a time, until the output delta is
# within an envelope.
# ---------------------------------------------------------------------------


def _weight_key(w: torch.Tensor) -> tuple:
    """A layer's identity in the collector: where its int8 weight lies and
    its shape. The q/k/v slices of a packed ``in_proj`` lie a third apart,
    so each resolves to its own name, as the JAX package's content hashes
    do (``hriemo/ops/quant.py::_weight_key``)."""
    return (w.data_ptr(), tuple(w.shape))


class AmaxCollector:
    """Per-layer activation amax and crest (amax / rms per row) of the
    inputs of every int8 Linear that runs through :func:`int8_linear_plain`
    while it is active."""

    def __init__(self, names_by_key: dict):
        self.names_by_key = names_by_key
        self.raw = {}

    @torch.no_grad()
    def record(self, w_int8, row_scales, x):
        name = self.names_by_key.get(_weight_key(w_int8))
        if name is None:
            name = f"unnamed_{tuple(w_int8.shape)}"
        amax = row_scales.double().reshape(-1) * 127.0
        xf = x.double()
        rms = torch.sqrt(torch.mean(xf * xf, dim=-1)).reshape(-1)
        # crest: how far a few channels dominate a row. Gaussian rows sit near
        # sqrt(2 ln n), ~3.6-3.8; one dominating channel pushes it toward sqrt(n)
        crest = amax / rms.clamp_min(1e-12)
        self.raw.setdefault(name, []).append((amax.cpu().numpy(), crest.cpu().numpy()))

    def stats(self) -> dict:
        out = {}
        for name, chunks in self.raw.items():
            a = np.concatenate([c[0] for c in chunks])
            cr = np.concatenate([c[1] for c in chunks])
            med = float(np.median(a))
            out[name] = {
                "rows": int(a.size),
                "amax_p50": med,
                "amax_p99": float(np.percentile(a, 99)),
                "amax_max": float(a.max()),
                "outlier_ratio": float(a.max() / max(med, 1e-12)),
                # p90, not the median: a ReLU can zero the dominating channel
                # in a share of the rows
                "crest_p50": float(np.median(cr)),
                "crest_p90": float(np.percentile(cr, 90)),
                "crest_max": float(cr.max()),
            }
        return out


@contextlib.contextmanager
def collect_activation_amax(module: torch.nn.Module):
    """Collect per-layer activation amax while int8 Linears of ``module``
    run through the plain route::

        with collect_activation_amax(qmodule) as col:
            apply_fn(qmodule, *probe)   # per op, use_kernels=False
        stats = col.stats()

    Only :func:`int8_linear_plain` records: fused blocks and the kernels
    never hold each Linear's input (the FFN's hidden activations stay inside
    the block), so quantize with ``fuse_blocks=False`` and run with
    ``use_kernels=False`` (``nn.layers.set_use_kernels``).
    """
    global _AMAX_COLLECTOR
    col = AmaxCollector(quantized_layer_names(module))
    prev, _AMAX_COLLECTOR = _AMAX_COLLECTOR, col
    try:
        yield col
    finally:
        _AMAX_COLLECTOR = prev


def _path(name: str) -> str:
    return name.replace(".", "/")


def quantized_layer_names(module: torch.nn.Module) -> dict:
    """Map each int8 weight's collector key to its "a/b/c" path, the q/k/v
    slices of a packed MHA ``in_proj`` as ``.../in_proj_q`` (``_k``,
    ``_v``), as the JAX package names them."""
    names = {}
    for name, m in module.named_modules():
        if getattr(m, "w_int8", None) is not None:
            names[_weight_key(m.w_int8)] = _path(name)
        w = getattr(m, "in_proj_w_int8", None)
        if w is not None:
            d = w.shape[0] // 3
            for i, nm in enumerate("qkv"):
                names[_weight_key(w[i * d:(i + 1) * d])] = _path(f"{name}.in_proj_{nm}")
    return names


def quantized_layer_paths(module: torch.nn.Module) -> list:
    """The "a/b/c" paths of every int8 layer of ``module``; a packed MHA
    counts once (its in_proj; excluding its path reverts its out_proj too)."""
    return [_path(name) for name, m in module.named_modules()
            if getattr(m, "w_int8", None) is not None
            or getattr(m, "in_proj_w_int8", None) is not None]


def _outputs(apply_fn, module, args) -> dict:
    with torch.no_grad():
        return {k: v.detach().double().cpu().numpy() for k, v in apply_fn(module, *args).items()}


def int8_numerics_report(apply_fn, module: torch.nn.Module, args, envelope: float = 0.005,
                         min_dim: int = DEFAULT_MIN_DIM, max_reverts: int = 8,
                         collect_amax: bool = True) -> dict:
    """int8 against full-precision output deltas, and the selective revert
    of outlier layers (``hriemo/ops/quant.py::int8_numerics_report``).

    ``apply_fn(module, *args) -> dict[str, tensor]`` (e.g. ``{"probs": ...,
    "beta": ...}``); its first key gates the envelope. ``module`` is the
    float model on its device; it is never changed: each attempt quantizes
    a fresh ``copy.deepcopy`` of it.

    Two routes, on purpose:

    * the statistics come from a pass of their own on a copy quantized with
      ``fuse_blocks=False`` and run with ``use_kernels=False``, so that every
      int8 Linear runs alone through :func:`int8_linear_plain`, where the
      collector records (the JAX package records in ``int8_linear``, its
      per-op route);
    * the deltas come from passes through the route the caller chose: the
      copies keep ``module``'s ``use_kernels`` and its fused blocks, so on
      the card they run the kernels.

    Mitigation: revert the worst layers to full precision greedily, ranked
    by ``crest_p90`` and then ``outlier_ratio``, until the gated delta is
    within ``envelope`` or ``max_reverts`` layers are reverted. Returns the
    JAX report's keys.
    """
    from ..nn.layers import set_use_kernels

    ref = _outputs(apply_fn, module, args)
    gate_key = next(iter(ref))

    def quantized_copy(exclude=frozenset(), fuse_blocks=True):
        return quantize_for_serving(copy.deepcopy(module), min_dim=min_dim, exclude=exclude,
                                    fuse_blocks=fuse_blocks)

    def deltas(q) -> dict:
        out = _outputs(apply_fn, q, args)
        return {k: float(np.abs(v - ref[k]).max()) for k, v in out.items()}

    act_stats = {}
    if collect_amax:
        q_stats = set_use_kernels(quantized_copy(fuse_blocks=False), False)
        with collect_activation_amax(q_stats) as col:
            _outputs(apply_fn, q_stats, args)
        act_stats = col.stats()
        del q_stats
    q_full = quantized_copy()
    n_quantized = count_quantized(q_full)
    d_full = deltas(q_full)
    del q_full

    report = {
        "envelope": envelope,
        "gate_output": gate_key,
        "n_quantized_layers": n_quantized,
        "deltas_full_int8": d_full,
        "activation_amax": act_stats,
        "reverted_layers": [],
        "deltas_final": d_full,
        "within_envelope": d_full[gate_key] <= envelope,
    }
    if report["within_envelope"] or not act_stats:
        return report

    def node_path(act_name):  # a packed MHA's q/k/v revert as their MHA
        parts = act_name.split("/")
        if parts[-1].startswith("in_proj_"):
            parts = parts[:-1]
        return "/".join(parts)

    ranked = sorted(act_stats, key=lambda n: (-act_stats[n]["crest_p90"],
                                              -act_stats[n]["outlier_ratio"]))
    order = list(dict.fromkeys(node_path(n) for n in ranked))
    d, reverted = d_full, []
    for p in order[:max_reverts]:
        reverted.append(p)
        d = deltas(quantized_copy(frozenset(reverted)))
        if d[gate_key] <= envelope:
            break
    report["reverted_layers"] = reverted
    report["deltas_final"] = d
    report["within_envelope"] = d[gate_key] <= envelope
    return report
