"""Shared helpers of the PyTorch port's parity tests (tests/test_torch_*.py).

The JAX package is the reference: the same numpy inputs go through the JAX
function and its counterpart in ``hriemo_torch``, and weights go across as
the JAX package's flat ``{name: array}`` parameters.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from hriemo.nn.module import flatten_params
from hriemo_torch.utils.convert import load_flat_params

# Kernel-path tolerance of the JAX kernel tests (tests/test_attention_block.py:111-115)
KERNEL_ATOL = KERNEL_RTOL = 5e-2
KERNEL_MEDIAN = 5e-3
# fp32 plain paths (masking, LayerNorm)
FP32_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Several test workers share the machine: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flat(params) -> dict:
    """JAX param tree -> ``{name: np.ndarray}``."""
    return {k: np.array(v) for k, v in flatten_params(params).items()}


def port(jax_module, torch_module):
    """Load a JAX module's parameters into its port counterpart."""
    return load_flat_params(torch_module, flat(jax_module.params))


def same_config(torch_cls, jax_cfg, **drop):
    """The port's config dataclass with the JAX config's values."""
    names = {f.name for f in dataclasses.fields(torch_cls)}
    return torch_cls(**{f.name: getattr(jax_cfg, f.name)
                        for f in dataclasses.fields(jax_cfg) if f.name in names})


def np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def assert_kernel_close(got, ref, atol=KERNEL_ATOL, rtol=KERNEL_RTOL,
                        median=KERNEL_MEDIAN):
    """Kernel-path agreement: allclose plus a tight median."""
    a, r = np32(got), np32(ref)
    assert a.shape == r.shape, (a.shape, r.shape)
    assert np.isfinite(a).all()
    np.testing.assert_allclose(a, r, atol=atol, rtol=rtol)
    med = float(np.median(np.abs(a - r)))
    assert med < median, med


def bf16(x) -> torch.Tensor:
    """numpy -> bf16 torch tensor."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """fp32 x with its 13 low mantissa bits cleared: the TF32 value a tensor
    core reads from fp32 bits."""
    return (x.float().contiguous().view(torch.int32) & -8192).view(torch.float32)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in fp32 as the card's 3xTF32 GEMM (hriemo_torch/csrc/
    float_wgmma.cuh) computes it: each operand split into big (masked to
    TF32) and small = x - big, small truncated to TF32 by the tensor core,
    then small.big + big.small + big.big with fp32 sums."""
    ab, bb = tf32_truncate(a), tf32_truncate(b)
    return tf32_truncate(a - ab) @ bb + ab @ tf32_truncate(b - bb) + ab @ bb


def matmul_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as one TF32 product: both operands truncated to TF32."""
    return tf32_truncate(a) @ tf32_truncate(b)
