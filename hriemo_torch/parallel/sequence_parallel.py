"""Sequence parallelism: ring attention over the model axis (port of
``hriemo/parallel/sequence_parallel.py:32-101``).

Each rank of the model axis holds a block of the sequence: its queries attend to
its own K/V block, then K, V and the key bias move one rank along the ring
(to rank ``(j + 1) % n``) and the partial results combine in an online
softmax, so a rank never holds the whole ``L x L`` score panel. The result
equals full softmax attention. The block step is plain ``torch`` products,
as JAX's is XLA ``einsum``s: no Pallas kernel sits here.

The rotation is point-to-point (``dist.batch_isend_irecv``), which NCCL
takes between cards and gloo takes for CPU tensors; it is never staged
through the host.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..core.masking import NEG_INF
from .mesh import Mesh


def _rotate(tensors, group, rank: int, n: int):
    """Each tensor sent to the next rank of ``group``'s ring, and received
    from the previous one."""
    nxt = dist.get_global_rank(group, (rank + 1) % n)
    prv = dist.get_global_rank(group, (rank - 1) % n)
    out = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), nxt, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, o, prv, group) for o in out]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


def ring_self_attention(q, k, v, key_padding_mask, group=None):
    """Ring attention over ``group`` (the default group when None): ``q``,
    ``k``, ``v`` are this rank's sequence blocks ``[B, H, L/n, hd]`` and
    ``key_padding_mask`` its ``[B, L/n]`` (True = PAD). Returns this rank's
    block of full softmax attention over the whole sequence, in q's dtype:
    q scaled by ``1/sqrt(hd)``, the ``NEG_INF`` key bias, fp32 running max,
    sum and accumulator, and ``p`` cast to v's dtype before PV, as in JAX."""
    group = dist.group.WORLD if group is None else group
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    if n > 1 and q.is_cuda and dist.get_backend(group) == "gloo":
        raise RuntimeError("ring_self_attention: gloo moves no CUDA tensors point to point; "
                           "the ring across ranks needs NCCL, a card per rank")
    q = q * (1.0 / math.sqrt(q.shape[-1]))
    bias = torch.where(key_padding_mask, NEG_INF, 0.0).to(torch.float32)
    b, h, lq, hd = q.shape
    out = torch.zeros((b, h, lq, hd), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, lq, 1), -math.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, lq, 1), dtype=torch.float32, device=q.device)
    for i in range(n):
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) + bias[:, None, None, :]
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        out = out * alpha + torch.matmul(p.to(v.dtype).float(), v.float())
        m = m_new
        if i < n - 1:  # the last rotation's blocks would go unused
            k, v, bias = _rotate((k, v, bias), group, rank, n)
    return (out / l).to(q.dtype)


def sp_self_attention(mesh: Mesh):
    """Returns ``f(q, k, v, key_padding_mask)``: the operands are whole
    (``[B, H, L, hd]``, mask ``[B, L]``), their sequence axis is sharded
    over the model axis of ``mesh``, and each rank returns its block of the
    output, ``[B, H, L/n, hd]``, by ring attention over the model group."""
    group, n, r = mesh.model_group, mesh.n_model, mesh.model_rank

    def attend(q, k, v, key_padding_mask):
        seq = q.shape[2]
        if seq % n:
            raise ValueError(f"sp_self_attention: L={seq} does not divide into {n} ranks")
        blk = slice(r * seq // n, (r + 1) * seq // n)
        return ring_self_attention(q[:, :, blk], k[:, :, blk], v[:, :, blk],
                                   key_padding_mask[:, blk], group)
    return attend
