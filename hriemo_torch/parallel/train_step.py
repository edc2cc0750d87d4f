"""Train and eval steps, on one device or over a mesh (port of
``hriemo/parallel/train_step.py:43-228``).

One step covers both trainers: loss type, beta regularizers, label
normalisation, ``pos_weight``, gradient accumulation, clipping and the
schedule are all config. As in JAX:

* the schedule is ``optax.warmup_cosine_decay_schedule`` (linear from 0 to
  ``lr`` over ``max(1, warmup_steps)`` steps, then cosine to 0 by
  ``max(2, total_steps)``) or constant;
* the update is optax's ``clip_by_global_norm`` (scale by ``c / |g|`` only
  when ``|g| >= c``), then AdamW (b1 0.9, b2 0.999, eps 1e-8, decay on the
  pre-update parameters), each step in optax's order of operations, under
  ``apply_if_finite``: a step with any non-finite gradient changes no
  parameter and no optimizer count, and the reported ``lr`` is
  ``sched(step - notfinite)``;
* ``compute_dtype=torch.bfloat16`` casts every fp32 master parameter (a
  differentiable cast, passed with ``torch.func.functional_call``) and
  ``h_a``/``h_t``; logits and beta go to fp32 before the loss;
* with ``grad_accum > 1`` the batch is ``[accum, micro, ...]``: gradients
  are summed in fp32 and scaled by ``1/accum``, loss and mean beta averaged;
* ``remat`` recomputes the forward in the backward
  (``torch.utils.checkpoint``).

The step makes no host sync: its metrics (``loss``, ``mean_beta``,
``grad_norm``, ``lr``) stay device tensors until the caller reads them.
Dropout masks come from the step's generator, one derived per micro-batch
(the model derives one per call site from its seed).

With ``mesh`` (``parallel/mesh.py``) a step over an ``n_data x n_model``
mesh equals the single-device step on the whole batch, as JAX's GSPMD step
does. Every rank builds the model from one seed; ``create_train_state``
checks that with one checksum and shards the FFNs. Each rank's batch is its
data block (``mesh.shard_batch``), and its dropout masks are its blocks of
the whole batch's. Gradients, loss and mean beta are averaged over the data
group in one flattened fp32 bucket (the shards are equal, so the mean of the
shard means is the global mean). The global norm counts replicated leaves
once and adds the sharded leaves' squared norms of every model rank, and
the non-finite skip is decided on a flag: both in one all-reduce over the
world, so every rank skips the same steps. The eval step returns the whole
batch's logits and beta on every rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any

import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..nn.layers import derive, dropout_rows
from ..train.losses import (bce_with_logits, beta_degeneracy_reward, beta_entropy_loss,
                            normalize_mosei_emotions, softmax_cross_entropy)
from .mesh import (Mesh, REPLICATED, all_reduce_flat, check_replicas, gather_rows,
                   param_shardings, shard_params, shard_tensor)

B1, B2, EPS = 0.9, 0.999, 1e-8
BATCH_KEYS = ("h_a", "h_t", "mask_a", "mask_t", "y")


@dataclasses.dataclass
class TrainConfig:
    # loss
    loss_type: str = "multi_label"  # single_label | multi_label
    pos_weight: Any = None          # [C] or None
    beta_entropy: float = 0.0       # MOSEI: + lambda * H(beta)
    beta_degeneracy: float = 0.0    # IEMOCAP decoder: - lambda * mean(beta (1 - beta))
    normalize_labels: bool = False  # MOSEI clamp(y, 0, 3) / 3
    # optimisation
    lr: float = 1e-4
    weight_decay: float = 1e-2
    grad_clip: float = 5.0
    grad_accum: int = 1
    warmup_steps: int = 0
    total_steps: int = 10_000
    schedule: str = "warmup_cosine"  # warmup_cosine | constant
    # numerics
    compute_dtype: torch.dtype = torch.float32
    # memory: recompute the forward in the backward
    remat: bool = False


def make_schedule(cfg: TrainConfig):
    """``sched(count) -> lr``, an fp32 tensor on count's device, in optax's
    order of fp32 operations. ``count`` is an int or an integer tensor."""
    lr = cfg.lr
    if cfg.schedule == "constant":
        return lambda count: torch.full((), lr, device=torch.as_tensor(count).device)
    warm = max(1, cfg.warmup_steps)
    decay = max(2, cfg.total_steps) - warm
    if decay <= 0:
        raise ValueError(f"warmup_cosine: total_steps {cfg.total_steps} must exceed the "
                         f"warmup's {warm} steps")

    def sched(count):
        count = torch.as_tensor(count)
        frac = 1 - count.clamp(0, warm).float() / warm
        rise = (0.0 - lr) * frac + lr
        c = torch.minimum((count - warm).float(), torch.tensor(float(decay), device=count.device))
        cosine = lr * (0.5 * (1 + torch.cos(math.pi * c / decay)))
        return torch.where(count < warm, rise, cosine)
    return sched


@dataclasses.dataclass
class TrainState:
    """The model (fp32 master parameters, updated in place), AdamW's moments
    and counts, all on the model's device."""
    model: nn.Module
    mu: list
    nu: list
    count: torch.Tensor            # applied (finite) updates: Adam's and the schedule's count
    step: torch.Tensor             # steps taken
    total_notfinite: torch.Tensor  # steps skipped for a non-finite gradient


def create_train_state(model: nn.Module, cfg: TrainConfig, mesh: Mesh | None = None) -> TrainState:
    """A fresh state of ``model``; with ``mesh``, sharded by
    :func:`shard_train_state` (the model too, in place)."""
    params = list(model.parameters())
    dev = params[0].device
    if any(p.dtype != torch.float32 for p in params):
        raise TypeError("create_train_state: the master parameters must be fp32")
    zero = lambda: torch.zeros((), dtype=torch.int32, device=dev)  # noqa: E731
    state = TrainState(model, [torch.zeros_like(p) for p in params],
                       [torch.zeros_like(p) for p in params], zero(), zero(), zero())
    return state if mesh is None else shard_train_state(state, mesh)


def shard_train_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Shard an unsharded state in place (a fresh one, or one restored
    whole from a checkpoint): after one checksum that every rank holds the
    same parameters, the model's FFNs and their moments keep this rank's
    blocks. Returns ``state``."""
    check_replicas(state.model, mesh)
    specs = param_shardings(mesh, state.model)
    state.mu = [shard_tensor(t, s, mesh) for t, s in zip(state.mu, specs.values())]
    state.nu = [shard_tensor(t, s, mesh) for t, s in zip(state.nu, specs.values())]
    shard_params(state.model, mesh)
    return state


def compute_loss(model: nn.Module, cfg: TrainConfig, batch: dict, generator=None,
                 pos_weight=None):
    """Returns ``(loss, logits, beta)``, the loss and fp32 logits and beta,
    in the model's current mode (``model.train()`` for a train step).
    ``pos_weight``: ``cfg.pos_weight`` as an fp32 tensor on the device."""
    h_a, h_t = batch["h_a"], batch["h_t"]
    mask_a, mask_t, y = batch["mask_a"], batch["mask_t"], batch["y"]
    dt = cfg.compute_dtype
    if dt != torch.float32:
        params = {n: p.to(dt) for n, p in model.named_parameters()}
        h_a, h_t = h_a.to(dt), h_t.to(dt)

        def fwd(h_a, h_t):
            return functional_call(model, params, (h_a, h_t, mask_a, mask_t),
                                   {"generator": generator})
    else:
        def fwd(h_a, h_t):
            return model(h_a, h_t, mask_a, mask_t, generator=generator)

    if cfg.remat and model.training:
        # the masks come from generators made inside fwd from the seed of
        # ``generator``, so the recompute draws them again as they were
        logits, beta, _ = checkpoint(fwd, h_a, h_t, use_reentrant=False,
                                     preserve_rng_state=False)
    else:
        logits, beta, _ = fwd(h_a, h_t)
    logits, beta = logits.float(), beta.float()

    if cfg.loss_type == "single_label":
        loss = softmax_cross_entropy(logits, y)
    else:
        targets = y.float()
        if cfg.normalize_labels:
            targets = normalize_mosei_emotions(targets)
        loss = bce_with_logits(logits, targets, pos_weight)
    if cfg.beta_entropy > 0:
        loss = loss + cfg.beta_entropy * beta_entropy_loss(beta)
    if cfg.beta_degeneracy > 0:
        loss = loss - cfg.beta_degeneracy * beta_degeneracy_reward(beta)
    return loss, logits, beta


def _pos_weight(cfg: TrainConfig, device):
    if cfg.pos_weight is None:
        return None
    return torch.as_tensor(cfg.pos_weight, dtype=torch.float32).to(device)


def compute_grads(model: nn.Module, cfg: TrainConfig, batch: dict, generator=None,
                  pos_weight=None):
    """One step's gradients in training mode: ``(loss, grads, mean_beta)``,
    ``grads`` fp32 in ``model.parameters()`` order. With ``grad_accum > 1``
    the batch is ``[accum, micro, ...]`` and micro-batch ``i`` draws its
    dropout from ``derive(generator, i)``."""
    model.train()
    params = list(model.parameters())
    if pos_weight is None:
        pos_weight = _pos_weight(cfg, params[0].device)

    def single(micro, gen):
        loss, _, beta = compute_loss(model, cfg, micro, gen, pos_weight)
        return loss, torch.autograd.grad(loss, params), beta.mean()

    if cfg.grad_accum == 1:
        loss, grads, mean_beta = single(batch, generator)
        return loss.detach(), list(grads), mean_beta.detach()
    grads = [torch.zeros_like(p) for p in params]
    loss_sum = beta_sum = 0.0
    for i in range(cfg.grad_accum):
        micro = {k: batch[k][i] for k in BATCH_KEYS}
        loss, g, mean_beta = single(micro, derive(generator, i))
        torch._foreach_add_(grads, g)
        loss_sum = loss_sum + loss.detach()
        beta_sum = beta_sum + mean_beta.detach()
    inv = 1.0 / cfg.grad_accum
    return loss_sum * inv, torch._foreach_mul(grads, inv), beta_sum * inv


UPDATE_CHUNK = 1 << 22  # elements one multi-tensor update touches at once


def _leaf_chunks(tensors):
    """Slices of consecutive leaves of at most ``UPDATE_CHUNK`` elements
    together (a larger leaf alone): the update's temporaries stay that small
    instead of several copies of the whole model."""
    start, size = 0, 0
    for i, t in enumerate(tensors):
        if size and size + t.numel() > UPDATE_CHUNK:
            yield slice(start, i)
            start, size = i, 0
        size += t.numel()
    if start < len(tensors):
        yield slice(start, len(tensors))


def apply_update(state: TrainState, grads, cfg: TrainConfig, sched, global_norm=None):
    """One optimizer update of ``state`` in place: optax's
    ``apply_if_finite(chain(clip_by_global_norm, adamw))``, each step in its
    order of fp32 operations, as multi-tensor (``torch._foreach_*``) ops
    over chunks of leaves.
    Returns ``(grad_norm, lr)``: the global norm before the clip, and the lr
    applied, ``sched(step - notfinite)`` (the schedule follows the
    applied-update count, which a skipped step does not advance).

    A leaf with a NaN or an infinity has a non-finite norm, so the step is
    skipped; so is one whose norm overflows fp32 (elements beyond ~1e19),
    where optax's own global norm is infinite and its clip zeroes the
    update.

    ``global_norm`` (a mesh's, :func:`mesh_norm`) maps the leaf norms to
    ``(norm, finite)`` in place of the single-device ones."""
    lr = sched(state.step - state.total_notfinite)
    params = list(state.model.parameters())
    norms = torch.stack(torch._foreach_norm(grads))
    if global_norm is None:
        g_norm = torch.linalg.vector_norm(norms)
        finite = torch.isfinite(norms).all()
    else:
        g_norm, finite = global_norm(norms)
    scale = torch.where(g_norm < cfg.grad_clip, 1.0, cfg.grad_clip / g_norm)
    count_inc = state.count + 1
    bc1 = 1 - torch.pow(torch.tensor(B1, device=lr.device), count_inc.float())
    bc2 = 1 - torch.pow(torch.tensor(B2, device=lr.device), count_inc.float())
    with torch.no_grad():
        for c in _leaf_chunks(params):
            p, mu0, nu0 = params[c], state.mu[c], state.nu[c]
            g = torch._foreach_mul(grads[c], scale)
            mu = torch._foreach_mul(g, 1 - B1)
            torch._foreach_add_(mu, torch._foreach_mul(mu0, B1))
            nu = torch._foreach_mul(g, g)
            torch._foreach_mul_(nu, 1 - B2)
            torch._foreach_add_(nu, torch._foreach_mul(nu0, B2))
            den = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, EPS)
            u = torch._foreach_div(mu, bc1)
            torch._foreach_div_(u, den)
            torch._foreach_add_(u, torch._foreach_mul(p, cfg.weight_decay))
            torch._foreach_mul_(u, -lr)
            new = torch._foreach_add(p, u)
            for olds, news in ((p, new), (mu0, mu), (nu0, nu)):
                for old, n in zip(olds, news):
                    torch.where(finite, n, old, out=old)
        state.count.copy_(torch.where(finite, count_inc, state.count))
        state.total_notfinite.add_((~finite).int())
        state.step.add_(1)
    return g_norm, lr


def mesh_norm(model: nn.Module, mesh: Mesh):
    """``norms -> (global norm, finite)`` of a sharded ``model``'s gradients
    (averaged over the data group) from this rank's leaf norms: one world
    all-reduce of the sharded leaves' squared norms (summed over the data
    ranks too, hence the division by ``n_data``) and of the non-finite flag.
    At one model rank the norm is the single-device one, bit for bit."""
    sharded = torch.tensor([s != REPLICATED for s in param_shardings(mesh, model).values()],
                           device=next(model.parameters()).device)

    def global_norm(norms):
        sq = norms.square()
        both = torch.stack([torch.where(sharded, sq, 0.0).sum(),
                            (~torch.isfinite(norms)).any().float()])
        dist.all_reduce(both)
        if mesh.n_model == 1:
            g_norm = torch.linalg.vector_norm(norms)
        else:
            g_norm = torch.sqrt(torch.where(sharded, 0.0, sq).sum() + both[0] / mesh.n_data)
        return g_norm, both[1] == 0
    return global_norm


def _rows_of(mesh: Mesh | None, batch: dict, cfg: TrainConfig):
    """Dropout draws this data rank's rows of the whole batch's masks."""
    if mesh is None or mesh.n_data == 1:
        return contextlib.nullcontext()
    return dropout_rows(mesh.data_rank * batch["h_a"].shape[1 if cfg.grad_accum > 1 else 0])


def make_train_step(model: nn.Module, cfg: TrainConfig, mesh: Mesh | None = None):
    """Returns ``step(state, batch, generator) -> (state, metrics)``: one
    update of ``state`` in place, on the device of the model's parameters;
    ``batch`` holds device tensors under ``BATCH_KEYS`` (``[accum, micro,
    ...]`` when ``cfg.grad_accum > 1``), ``generator`` draws the dropout
    masks (None only when no dropout is active). Under ``mesh`` the state
    is sharded (``create_train_state(..., mesh)``), ``batch`` is this rank's
    data block, ``generator`` is the same on every rank, and the metrics
    are the whole batch's."""
    sched = make_schedule(cfg)
    pos_weight = _pos_weight(cfg, next(model.parameters()).device)
    global_norm = None if mesh is None else mesh_norm(model, mesh)

    def step(state: TrainState, batch: dict, generator=None):
        with _rows_of(mesh, batch, cfg):
            loss, grads, mean_beta = compute_grads(state.model, cfg, batch, generator,
                                                   pos_weight)
        if mesh is not None and mesh.n_data > 1:
            *grads, loss, mean_beta = all_reduce_flat([*grads, loss, mean_beta],
                                                      mesh.data_group)
            inv = 1.0 / mesh.n_data
            grads, loss, mean_beta = torch._foreach_mul(grads, inv), loss * inv, mean_beta * inv
        g_norm, lr = apply_update(state, grads, cfg, sched, global_norm)
        return state, {"loss": loss, "mean_beta": mean_beta, "grad_norm": g_norm, "lr": lr}
    return step


def make_eval_step(model: nn.Module, cfg: TrainConfig, mesh: Mesh | None = None):
    """Returns ``eval(batch) -> (loss, logits, beta)`` in eval mode, no grad.
    Under ``mesh``, ``batch`` is this rank's data block and every rank gets
    the whole batch's loss, logits and beta."""
    pos_weight = _pos_weight(cfg, next(model.parameters()).device)

    @torch.no_grad()
    def eval_step(batch: dict):
        model.eval()
        loss, logits, beta = compute_loss(model, cfg, batch, None, pos_weight)
        if mesh is None:
            return loss, logits, beta
        logits, beta, loss = gather_rows([logits, beta], mesh, means=[loss])
        return loss, logits, beta
    return eval_step
