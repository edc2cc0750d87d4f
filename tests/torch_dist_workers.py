"""Rank functions of the port's multi-device tests (tests/test_torch_parallel.py,
tests/test_torch_ring_attention.py).

A rank started by ``hriemo_torch.parallel.launch.spawn`` imports the module
of its target, so this module imports no JAX and nothing of the test
modules. Every function here also runs without a mesh (``shape=None``), in
the test's own process, as the single-process reference. Inputs and results
are numpy arrays and plain data.
"""

from __future__ import annotations

import numpy as np
import torch

import hriemo_torch.models as TM
from hriemo_torch.ops.quant import quantize_for_serving
from hriemo_torch.parallel import mesh as PM
from hriemo_torch.parallel import train_step as TS
from hriemo_torch.parallel.sequence_parallel import sp_self_attention
from hriemo_torch.utils.convert import load_flat_params

# tests/test_parallel.py::_model
MOSEI = dict(d_audio=8, d_text=12, d_model=32, num_emotions=6, n_heads=4, num_layers_fusion=1,
             num_layers_decoder=1, beta_hidden=16)


def run_jobs(device, jobs):
    """``[(function name, kwargs), ...]`` of this module, run in order on
    every rank: one spawn serves a test module's cases."""
    return [globals()[name](**kw) for name, kw in jobs]


def _mesh(shape):
    return None if shape is None else PM.make_mesh(*shape)


def mosei_model(params=None, dropout=0.0, seed=0):
    """The tiny MOSEI model: the JAX model's parameters, or init from ``seed``."""
    model = TM.MoseiFusionWithEmotionDecoder(**MOSEI, dropout=dropout)
    if params is None:
        model.init_weights(torch.Generator().manual_seed(seed))
        return model
    return load_flat_params(model, params)


def _local(batch, mesh, accum=1):
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    return batch if mesh is None else PM.shard_batch(batch, mesh, accum)


def train_steps(shape, cfg, batches, params=None, dropout=0.0, gen_seed=None):
    """Steps of the tiny MOSEI model over the mesh ``shape`` (``(n_data,
    n_model)``; None: one process) on the whole ``batches``: each step's
    metrics, the whole parameters after them, and the counts. Step ``i``
    draws dropout from a generator seeded ``gen_seed + i``."""
    mesh = _mesh(shape)
    model = mosei_model(params, dropout)
    cfg = TS.TrainConfig(**cfg)
    state = TS.create_train_state(model, cfg, mesh)
    step = TS.make_train_step(model, cfg, mesh)
    metrics = []
    for i, batch in enumerate(batches):
        gen = None if gen_seed is None else torch.Generator().manual_seed(gen_seed + i)
        state, m = step(state, _local(batch, mesh, cfg.grad_accum), gen)
        metrics.append({k: float(v) for k, v in m.items()})
    sd = PM.full_state_dict(model, mesh)
    return dict(metrics=metrics, params={k: v.numpy().copy() for k, v in sd.items()},
                counts=[int(state.step), int(state.count), int(state.total_notfinite)])


@torch.no_grad()
def evaluate(shape, batch, params):
    """The eval step over ``shape`` on the whole ``batch``: loss, logits, beta."""
    mesh = _mesh(shape)
    model = mosei_model(params)
    cfg = TS.TrainConfig(loss_type="multi_label", normalize_labels=True)
    if mesh is not None:
        TS.create_train_state(model, cfg, mesh)
    loss, logits, beta = TS.make_eval_step(model, cfg, mesh)(_local(batch, mesh))
    return float(loss), logits.numpy(), beta.numpy()


@torch.no_grad()
def int8_forward(shape, inputs, seed=0):
    """The int8 fusion model (d=128, the kernels' smallest widths) on the
    whole batch ``inputs`` (h_a, h_t, mask_a, mask_t): each data rank runs
    its rows, and every rank gathers the whole batch's logits and beta."""
    mesh = _mesh(shape)
    model = TM.FusionWithEmotionDecoder(d_model=128, num_emotions=4, n_heads=2,
                                        num_layers_fusion=1, num_layers_decoder=1,
                                        beta_hidden=128, dropout=0.0)
    model.init_weights(torch.Generator().manual_seed(seed))
    quantize_for_serving(model.eval(), min_dim=128)
    x = [torch.from_numpy(v) for v in inputs]
    if mesh is not None:
        b = x[0].shape[0] // mesh.n_data
        x = [t[mesh.data_rank * b:(mesh.data_rank + 1) * b] for t in x]
    logits, beta, _ = model(*x)
    if mesh is not None:
        logits, beta = PM.gather_rows([logits, beta], mesh)
    return logits.numpy(), beta.numpy()


def ring(shape, q, k, v, mask, dtype="float32"):
    """This rank's block of ring attention over the model axis of the mesh
    ``shape``, in fp32 or bf16 (returned as fp32)."""
    attend = sp_self_attention(PM.make_mesh(*shape))
    dt = getattr(torch, dtype)
    out = attend(*(torch.from_numpy(a).to(dt) for a in (q, k, v)), torch.from_numpy(mask))
    assert out.dtype == dt
    return out.float().numpy()


def make_mesh_refuses(n_data, n_model):
    """True when ``make_mesh(n_data, n_model)`` raises ``ValueError``."""
    try:
        PM.make_mesh(n_data, n_model)
    except ValueError:
        return True
    return False
