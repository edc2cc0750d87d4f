"""Multi-device dry run (counterpart of ``dryrun_multichip`` in
``__graft_entry__.py:77-341``), on ``n`` ranks of ``torch.distributed``.

    python -m hriemo_torch.parallel.dryrun 2                # 2 ranks on the card(s)
    python -m hriemo_torch.parallel.dryrun 8 --device cpu   # 8 gloo ranks on the CPU

Each rank runs, over the mesh ``(n / n_model) x n_model`` (``n_model = 2``
when ``n`` is even and at least 4, else 1):

* one DP x TP train step of the tiny MOSEI model (dropout 0.1,
  ``grad_accum=2``, two samples per data rank per micro-batch): the loss
  finite and the step counted;
* ring attention over the model axis at ``L = 8 n_model``, against full
  softmax attention;
* data-parallel serving of the tiny float tree (WavLM, BERT and the fusion
  model at d=32): each data rank serves its rows, every rank gathers the
  whole batch's probabilities;
* the same for the int8 tree at the smallest widths the kernels take (d=128,
  head dim 64), held to the single-process result on the whole batch at
  JAX's 5e-3 (on a card through the kernels, on the CPU through their plain
  versions).

It prints one ``dryrun_multichip OK: ...`` line.
"""

from __future__ import annotations

import argparse
import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist

INT8_TOL = 5e-3  # __graft_entry__.py:322-331


def _serve(wavlm, bert, fusion, wavs, wmask, ids, tmask):
    h_a, fmask = wavlm(wavs, wmask)
    h_t, _ = bert(ids, tmask)
    logits, beta, _ = fusion(h_a, h_t.to(h_a.dtype), fmask == 0, tmask == 0)
    return torch.sigmoid(logits), beta


def _serving_inputs(rng, b, t, lt, dev):
    wavs = torch.from_numpy(rng.standard_normal((b, t)).astype(np.float32) * 0.1).to(dev)
    ids = torch.from_numpy(rng.integers(0, 99, size=(b, lt))).to(dev)
    ones = lambda n: torch.ones((b, n), dtype=torch.int32, device=dev)  # noqa: E731
    return wavs, ones(t), ids, ones(lt)


def _serving_tree(seed, dev, hidden=None, fusion_d=32, beta_hidden=16, heads=4):
    from ..frontends import BertConfig, BertEncoder, WavLMConfig, WavLMEncoder
    from ..models import FusionWithEmotionDecoder

    kw = {} if hidden is None else dict(hidden_size=hidden, num_attention_heads=2,
                                        intermediate_size=2 * hidden)
    gen = torch.Generator().manual_seed(seed)
    wavlm = WavLMEncoder(dataclasses.replace(WavLMConfig.tiny(**kw), fast_gelu=True))
    bert = BertEncoder(dataclasses.replace(BertConfig.tiny(**kw), fast_gelu=True))
    fusion = FusionWithEmotionDecoder(d_model=fusion_d, num_emotions=4, n_heads=heads,
                                      num_layers_fusion=1, num_layers_decoder=1,
                                      beta_hidden=beta_hidden, dropout=0.0)
    for m in (wavlm, bert, fusion):
        m.init_weights(gen)
    return [m.to(dev).eval() for m in (wavlm, bert, fusion)]


def _rows(mesh, *tensors):
    b = tensors[0].shape[0] // mesh.n_data
    return [t[mesh.data_rank * b:(mesh.data_rank + 1) * b] for t in tensors]


@torch.no_grad()
def _dp_serving(mesh, dev) -> str:
    from .mesh import gather_rows

    tree = _serving_tree(1, dev)
    b = 2 * mesh.n_data
    inputs = _serving_inputs(np.random.default_rng(0), b, 400, 6, dev)
    probs, beta = gather_rows(_serve(*tree, *_rows(mesh, *inputs)), mesh)
    if probs.shape != (b, 4) or not (torch.isfinite(probs).all() and (probs >= 0).all()
                                     and (probs <= 1).all() and torch.isfinite(beta).all()):
        raise AssertionError(f"dp serving: probabilities {probs}")
    return f"e2e serving (WavLM+BERT+fusion, B={b} dp over {mesh.n_data}) OK"


@torch.no_grad()
def _dp_serving_int8(mesh, dev) -> str:
    from ..ops.quant import quantize_for_serving
    from .mesh import gather_rows

    tree = [quantize_for_serving(m, min_dim=128)
            for m in _serving_tree(2, dev, hidden=128, fusion_d=128, beta_hidden=128, heads=2)]
    b = 2 * mesh.n_data
    inputs = _serving_inputs(np.random.default_rng(1), b, 1600, 16, dev)  # 79 frames
    single = _serve(*tree, *inputs)
    sharded = gather_rows(_serve(*tree, *_rows(mesh, *inputs)), mesh)
    delta = max(float((s - g).abs().max()) for s, g in zip(single, sharded))
    if not delta <= INT8_TOL:
        raise AssertionError(f"int8 sharded != single-process: max delta {delta:.2e}")
    return (f"int8 e2e serving (quantized tree, B={b} dp over {mesh.n_data}) == "
            f"single-process (max delta {delta:.2e})")


def _ring(mesh, dev) -> str:
    from .sequence_parallel import sp_self_attention

    if mesh.n_model == 1:
        return "sp skipped (n_model=1)"
    if dev.type == "cuda" and dist.get_backend() == "gloo":
        return "sp skipped (ranks share a card: gloo moves no CUDA tensors point to point)"
    l = 8 * mesh.n_model
    q = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 4, l, 16))
                         .astype(np.float32)).to(dev)
    mask = torch.zeros((2, l), dtype=torch.bool, device=dev)
    out = sp_self_attention(mesh)(q, q, q, mask)
    full = torch.softmax((q / math.sqrt(16)) @ q.transpose(-1, -2), dim=-1) @ q
    blk = full[:, :, mesh.model_rank * 8:(mesh.model_rank + 1) * 8]
    err = float((out - blk).abs().max())
    if not err <= 2e-5:
        raise AssertionError(f"ring attention: max |error| {err} against full attention")
    return f"sp ring attention OK (L={l} over {mesh.n_model} shards, max err {err:.1e})"


def _dryrun_rank(dev, n: int) -> str:
    from ..models import MoseiFusionWithEmotionDecoder
    from .mesh import make_mesh, shard_batch
    from .train_step import TrainConfig, create_train_state, make_train_step

    n_model = 2 if n % 2 == 0 and n >= 4 else 1
    mesh = make_mesh(n // n_model, n_model)
    model = MoseiFusionWithEmotionDecoder(
        d_audio=16, d_text=24, d_model=32, num_emotions=6, n_heads=4, num_layers_fusion=1,
        num_layers_decoder=1, beta_hidden=16, dropout=0.1)
    model.init_weights(torch.Generator().manual_seed(0))
    model.to(dev)
    accum = 2
    cfg = TrainConfig(loss_type="multi_label", normalize_labels=True, beta_entropy=1e-3,
                      lr=1e-4, grad_accum=accum, warmup_steps=2, total_steps=10)
    state = create_train_state(model, cfg, mesh)
    step = make_train_step(model, cfg, mesh)
    micro = 2 * mesh.n_data
    rng = np.random.default_rng(0)
    batch = {"h_a": rng.standard_normal((accum, micro, 8, 16)).astype(np.float32),
             "h_t": rng.standard_normal((accum, micro, 6, 24)).astype(np.float32),
             "mask_a": np.zeros((accum, micro, 8), bool),
             "mask_t": np.zeros((accum, micro, 6), bool),
             "y": rng.uniform(0, 3, size=(accum, micro, 6)).astype(np.float32)}
    local = {k: torch.from_numpy(v).to(dev) for k, v in shard_batch(batch, mesh, accum).items()}
    state, metrics = step(state, local, torch.Generator(dev).manual_seed(0))
    loss = float(metrics["loss"])
    if not (math.isfinite(loss) and int(state.step) == 1):
        raise AssertionError(f"train step: loss {loss}, step {int(state.step)}")
    notes = [_ring(mesh, dev), _dp_serving(mesh, dev), _dp_serving_int8(mesh, dev)]
    return (f"dryrun_multichip OK: mesh=({mesh.n_data} data x {n_model} model), "
            f"loss={loss:.4f}, grad_norm={float(metrics['grad_norm']):.4f}; "
            + "; ".join(notes))


def dryrun_multichip(n: int, device=None) -> str:
    """Run the dry run on ``n`` ranks of ``device`` (None: the card, and
    raises without one; on cards rank ``r`` takes card ``r % count``);
    prints and returns its ``dryrun_multichip OK`` line, and raises if a
    rank fails."""
    from ..device import resolve_device
    from .launch import spawn

    line = spawn(_dryrun_rank, n, resolve_device(device), n, timeout=600)[0]
    print(line, flush=True)
    return line


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, help="ranks")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.device)


if __name__ == "__main__":
    main()
