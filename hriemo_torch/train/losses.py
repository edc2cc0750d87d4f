"""Losses and regularizers (port of ``hriemo/train/losses.py:20-61``).

The two beta regularizers pull in opposite directions, and both are part of
the contract: the IEMOCAP decoder trainer rewards beta near 0.5 (``loss -
0.01 * mean(beta (1 - beta))``), the MOSEI trainer penalises an undecided
gate (``loss + lambda * mean(H(beta))``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bce_with_logits(logits, targets, pos_weight=None):
    """Mean BCE-with-logits as ``nn.BCEWithLogitsLoss(pos_weight=...)``, in the
    stable form ``-(w y log s(x) + (1 - y) log s(-x))``."""
    log_sig, log_sig_neg = F.logsigmoid(logits), F.logsigmoid(-logits)
    pos = targets * log_sig if pos_weight is None else pos_weight * targets * log_sig
    return (-(pos + (1.0 - targets) * log_sig_neg)).mean()


def softmax_cross_entropy(logits, labels):
    """Mean CE over integer labels, as ``nn.CrossEntropyLoss``."""
    logp = torch.log_softmax(logits, dim=-1)
    return (-logp.gather(-1, labels[:, None].long())[:, 0]).mean()


def beta_entropy_loss(beta, eps: float = 1e-8):
    """Binary entropy of the gate, clipped to ``[eps, 1 - eps]`` (in fp32 the
    upper clip rounds to 1, as in JAX); added to favour decisive gates."""
    b = beta.clamp(eps, 1.0 - eps)
    return (-(b * torch.log(b) + (1.0 - b) * torch.log(1.0 - b))).mean()


def beta_degeneracy_reward(beta):
    """``mean(beta (1 - beta))``; subtracted (x 0.01) to keep beta off 0 and 1."""
    return (beta * (1.0 - beta)).mean()


def normalize_mosei_emotions(y):
    """``clamp(y, 0, 3) / 3``: soft targets in [0, 1]."""
    return y.clamp(0.0, 3.0) / 3.0
