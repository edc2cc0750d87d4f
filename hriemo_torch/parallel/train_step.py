"""Train and eval steps on one device (port of
``hriemo/parallel/train_step.py:43-228``, without the mesh).

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
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..nn.layers import derive
from ..train.losses import (bce_with_logits, beta_degeneracy_reward, beta_entropy_loss,
                            normalize_mosei_emotions, softmax_cross_entropy)

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


def create_train_state(model: nn.Module, cfg: TrainConfig) -> TrainState:
    params = list(model.parameters())
    dev = params[0].device
    if any(p.dtype != torch.float32 for p in params):
        raise TypeError("create_train_state: the master parameters must be fp32")
    zero = lambda: torch.zeros((), dtype=torch.int32, device=dev)  # noqa: E731
    return TrainState(model, [torch.zeros_like(p) for p in params],
                      [torch.zeros_like(p) for p in params], zero(), zero(), zero())


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


def apply_update(state: TrainState, grads, cfg: TrainConfig, sched):
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
    update."""
    lr = sched(state.step - state.total_notfinite)
    params = list(state.model.parameters())
    norms = torch.stack(torch._foreach_norm(grads))
    g_norm = torch.linalg.vector_norm(norms)
    finite = torch.isfinite(norms).all()
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


def make_train_step(model: nn.Module, cfg: TrainConfig):
    """Returns ``step(state, batch, generator) -> (state, metrics)``: one
    update of ``state`` in place, on the device of the model's parameters;
    ``batch`` holds device tensors under ``BATCH_KEYS`` (``[accum, micro,
    ...]`` when ``cfg.grad_accum > 1``), ``generator`` draws the dropout
    masks (None only when no dropout is active)."""
    sched = make_schedule(cfg)
    pos_weight = _pos_weight(cfg, next(model.parameters()).device)

    def step(state: TrainState, batch: dict, generator=None):
        loss, grads, mean_beta = compute_grads(state.model, cfg, batch, generator, pos_weight)
        g_norm, lr = apply_update(state, grads, cfg, sched)
        return state, {"loss": loss, "mean_beta": mean_beta, "grad_norm": g_norm, "lr": lr}
    return step


def make_eval_step(model: nn.Module, cfg: TrainConfig):
    """Returns ``eval(batch) -> (loss, logits, beta)`` in eval mode, no grad."""
    pos_weight = _pos_weight(cfg, next(model.parameters()).device)

    @torch.no_grad()
    def eval_step(batch: dict):
        model.eval()
        return compute_loss(model, cfg, batch, None, pos_weight)
    return eval_step
