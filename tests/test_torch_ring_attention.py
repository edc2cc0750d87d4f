"""PyTorch port: ring attention (hriemo_torch/parallel/sequence_parallel.py)
on 2 and 4 gloo ranks against the JAX package's ``sp_self_attention`` on
its CPU mesh, with padded keys (tests/test_sequence_parallel.py's inputs)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hriemo.core.masking import NEG_INF
from hriemo.parallel import make_mesh as jax_make_mesh
from hriemo.parallel.sequence_parallel import sp_self_attention
from hriemo_torch.parallel.launch import spawn

import torch_dist_workers as W
from torch_port_helpers import KERNEL_ATOL, bf16, one_torch_thread  # noqa: F401


def _qkv(n_shards, seed=0, b=2, h=4, hd=16):
    rng = np.random.default_rng(seed)
    l = 8 * n_shards
    q, k, v = (rng.standard_normal((b, h, l, hd)).astype(np.float32) for _ in range(3))
    mask = np.zeros((b, l), bool)
    mask[0, l - 3:] = True
    mask[1, l // 2:] = True  # element 1's keys end inside an earlier shard
    return q, k, v, mask


def _jobs(n):
    jobs = [("ring", dict(shape=(1, n), **dict(zip("qkv", _qkv(n)[:3]), mask=_qkv(n)[3])))]
    if n == 2:  # one rank's ring (no rotation), and bf16 over two
        jobs += [("ring", dict(shape=(2, 1), **dict(zip("qkv", _qkv(1)[:3]), mask=_qkv(1)[3]))),
                 ("ring", dict(shape=(1, 2), dtype="bfloat16",
                               **dict(zip("qkv", _qkv(2, seed=1)[:3]), mask=_qkv(2, seed=1)[3])))]
    return jobs


@pytest.fixture(scope="module")
def rings():
    return {n: spawn(W.run_jobs, n, "cpu", _jobs(n), timeout=300) for n in (2, 4)}


def _dense(q, k, v, mask):
    s = (q / math.sqrt(q.shape[-1])) @ np.swapaxes(k, -1, -2)
    s = s + np.where(mask, NEG_INF, 0.0)[:, None, None, :]
    p = np.exp(s - s.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)) @ v


@pytest.mark.parametrize("n", [2, 4])
def test_ring_matches_jax_sp_self_attention(rings, n):
    """Each model rank's block, in rank order, is JAX's ring output over
    ``n`` shards (and full attention) at 1e-5 in fp32."""
    q, k, v, mask = _qkv(n)
    ref = np.asarray(sp_self_attention(jax_make_mesh(n_data=8 // n, n_model=n))(
        *(jnp.asarray(a) for a in (q, k, v, mask))))
    got = np.concatenate([r[0] for r in rings[n]], axis=2)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, _dense(q, k, v, mask), atol=1e-5, rtol=0)


def test_ring_on_one_rank_and_in_bf16(rings):
    """A ring of one rank is the block step alone over the whole sequence;
    in bf16 (``p`` rounded to bf16 before PV, as in JAX) the two-rank ring
    matches JAX's bf16 ring at the kernel-path tolerance."""
    q, k, v, mask = _qkv(1)
    for r in rings[2]:
        np.testing.assert_allclose(r[1], _dense(q, k, v, mask), atol=1e-5, rtol=0)
    q, k, v, mask = _qkv(2, seed=1)
    ref = sp_self_attention(jax_make_mesh(n_data=4, n_model=2))(
        *(jnp.asarray(bf16(a).float().numpy(), jnp.bfloat16) for a in (q, k, v)),
        jnp.asarray(mask))
    got = np.concatenate([r[2] for r in rings[2]], axis=2)
    np.testing.assert_allclose(got, np.asarray(ref.astype(jnp.float32)), atol=KERNEL_ATOL,
                               rtol=0)
    assert torch.from_numpy(got).isfinite().all()
