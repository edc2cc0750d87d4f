"""The ``(data, model)`` mesh on ``torch.distributed`` (port of
``hriemo/parallel/mesh.py``).

* **data axis**: each data rank holds a block of the batch; gradients are
  averaged over the data group (``train_step.py``).
* **model axis**: Megatron tensor parallelism on the FFNs. The first FFN
  Linear (``ffn_[at].0``, the decoder's ``linear1``) keeps a block of its
  output features (column-parallel), the second (``ffn_[at].2``,
  ``linear2``) the same block of its input features (row-parallel), so one
  all-reduce per FFN forward (and one per backward) is the only collective
  of the model axis. Attention stays replicated, as in JAX.

Ranks are laid out row-major as ``reshape(n_data, n_model)``
(``mesh.py:58``): a model group is ``n_model`` consecutive ranks, a data
group the ranks ``n_model`` apart. Where JAX's partitioner inserts the
collectives, two ``torch.autograd.Function``s carry them here: identity
forward and all-reduce backward at a column-parallel input, all-reduce
forward and identity backward at a row-parallel output. The row-parallel
bias stays whole and is added once, after the reduction.

A parameter's spec is a tuple, ``tuple(PartitionSpec)`` of JAX's rule:
``("model", None)``, ``("model",)``, ``(None, "model")`` or ``()``
(replicated).
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..nn.layers import Linear

DATA_AXIS = "data"
MODEL_AXIS = "model"
REPLICATED = ()

# (regex on the state-dict name) -> spec; the first match wins. torch
# layout: a Linear weight is [out, in].
_TP_RULES: list[tuple[str, tuple]] = [
    # column-parallel: FFN up-projections / decoder linear1
    (r"\.(ffn_[at]\.0|linear1)\.weight$", (MODEL_AXIS, None)),
    (r"\.(ffn_[at]\.0|linear1)\.bias$", (MODEL_AXIS,)),
    # row-parallel: FFN down-projections / decoder linear2 (bias replicated)
    (r"\.(ffn_[at]\.2|linear2)\.weight$", (None, MODEL_AXIS)),
]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the mesh and the groups of its two axes."""
    n_data: int
    n_model: int
    rank: int
    data_group: dist.ProcessGroup
    model_group: dist.ProcessGroup

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_model

    @property
    def model_rank(self) -> int:
        return self.rank % self.n_model

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}


def make_mesh(n_data: int | None = None, n_model: int = 1) -> Mesh:
    """The ``(data, model)`` mesh over the world of the default process
    group; ``n_data=None`` means ``world // n_model``. Every rank must call
    it (it makes every group on every rank, in one order). A world that
    ``n_data x n_model`` does not fill raises: an idle process cannot stand
    by as an idle chip can."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data is None:
        if world % n_model:
            raise ValueError(f"make_mesh: {world} ranks do not divide into n_model={n_model}")
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"make_mesh: {n_data} x {n_model} does not fill {world} ranks")
    grid = np.arange(world).reshape(n_data, n_model)
    model_group = data_group = None
    for i in range(n_data):
        g = dist.new_group(grid[i].tolist())
        if rank in grid[i]:
            model_group = g
    for j in range(n_model):
        g = dist.new_group(grid[:, j].tolist())
        if rank in grid[:, j]:
            data_group = g
    return Mesh(n_data, n_model, rank, data_group, model_group)


def _spec_for(name: str, mesh: Mesh) -> tuple:
    if mesh.n_model > 1:
        for pattern, spec in _TP_RULES:
            if re.search(pattern, name):
                return spec
    return REPLICATED


def param_shardings(mesh: Mesh, model: nn.Module) -> dict:
    """``{parameter name: spec}`` in ``named_parameters`` order (the TP
    rules when the model axis has more than one rank)."""
    return {name: _spec_for(name, mesh) for name, _ in model.named_parameters()}


# --------------------------------------------------------- collectives


def all_reduce_flat(tensors, group) -> list:
    """Sum each tensor over ``group``, one flattened bucket per dtype (one
    collective each); returns new tensors of the same shapes."""
    out = list(tensors)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        for i, piece in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = piece.view(tensors[i].shape)
    return out


def _all_reduce_fp32(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` in fp32, in x's dtype; x is not changed."""
    y = x.to(torch.float32, copy=True)
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    """Identity forward, all-reduce backward over the model group: the input
    of a column-parallel Linear, whose gradient each rank holds in part."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_fp32(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce forward, identity backward over the model group: the
    partial sums of a row-parallel Linear."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_fp32(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


@dataclasses.dataclass
class ParallelLinear:
    """How a sharded ``Linear`` runs (``Linear.tp``): ``kind`` "column" or
    "row", the model group, and the block ``[offset, offset + size)`` of
    ``total`` features that this rank holds (output features of a column
    Linear, input features of a row Linear)."""
    kind: str
    group: dist.ProcessGroup
    offset: int
    total: int

    def __call__(self, x, weight, bias):
        if self.kind == "column":
            y = torch.matmul(_CopyToModel.apply(x, self.group), weight.t())
        else:
            y = _ReduceFromModel.apply(torch.matmul(x, weight.t()), self.group)
        return y if bias is None else y + bias


# ---------------------------------------------------- sharding tensors


def _sharded_dim(spec: tuple) -> int | None:
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def shard_tensor(t: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """This model rank's block of the whole tensor ``t`` under ``spec``."""
    dim = _sharded_dim(spec)
    if dim is None or mesh.n_model == 1:
        return t
    size = t.shape[dim]
    if size % mesh.n_model:
        raise ValueError(f"shard_tensor: {size} features do not divide into "
                         f"{mesh.n_model} model ranks")
    block = size // mesh.n_model
    return t.narrow(dim, mesh.model_rank * block, block).clone()


def gather(tensors, dim: int, index: int, n: int, group, means=()) -> list:
    """Each tensor of ``tensors`` made whole along ``dim`` from the blocks of
    the ``n`` ranks of ``group`` (this rank's is block ``index``), on every
    rank, then the group mean of each tensor of ``means``: each rank writes
    its block into zeros, then one ``all_reduce`` per dtype, which is exact
    (gloo's CUDA tensors have no ``all_gather``)."""
    full = []
    for t in tensors:
        shape = list(t.shape)
        shape[dim] *= n
        buf = t.new_zeros(shape)
        buf.narrow(dim, index * t.shape[dim], t.shape[dim]).copy_(t)
        full.append(buf)
    return all_reduce_flat(full + [m / n for m in means], group)


def full_tensor(t: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """The whole tensor from this rank's block under ``spec`` (a collective
    of the model group)."""
    dim = _sharded_dim(spec)
    if dim is None or mesh.n_model == 1:
        return t
    return gather([t], dim, mesh.model_rank, mesh.n_model, mesh.model_group)[0]


def shard_params(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Apply the TP rules to ``model`` in place: each column-parallel Linear
    keeps rows ``[m F/n, (m+1) F/n)`` of its weight and bias, each
    row-parallel Linear the same columns of its weight and its whole bias,
    and both run through :class:`ParallelLinear`. Returns ``model``."""
    if mesh.n_model == 1:
        return model
    specs = param_shardings(mesh, model)
    for name, mod in model.named_modules():
        spec = specs.get(f"{name}.weight")
        if not isinstance(mod, Linear) or spec in (None, REPLICATED):
            continue
        if mod.w_int8 is not None:
            raise ValueError(f"shard_params: {name} is int8; int8 serving does not shard")
        kind, dim = ("column", 0) if spec == (MODEL_AXIS, None) else ("row", 1)
        total = mod.weight.shape[dim]
        with torch.no_grad():
            mod.weight = nn.Parameter(shard_tensor(mod.weight.detach(), spec, mesh))
            if kind == "column" and mod.bias is not None:
                mod.bias = nn.Parameter(shard_tensor(mod.bias.detach(), (MODEL_AXIS,), mesh))
        mod.tp = ParallelLinear(kind, mesh.model_group,
                                mesh.model_rank * total // mesh.n_model, total)
    return model


def full_state_dict(model: nn.Module, mesh: Mesh | None) -> dict:
    """``model.state_dict()`` with every sharded leaf made whole: the names
    and shapes of the unsharded model (a collective of the model group)."""
    sd = model.state_dict()
    if mesh is None or mesh.n_model == 1:
        return sd
    return {k: full_tensor(v, _spec_for(k, mesh), mesh) for k, v in sd.items()}


def check_replicas(model: nn.Module, mesh: Mesh) -> None:
    """Every rank built the same parameters (from the same seed): one
    all-reduced checksum (max of ``(c, -c)`` over the world) before
    sharding. Raises on a mismatch."""
    params = list(model.parameters())
    c = sum((i + 1) * p.detach().double().sum() + p.detach().double().square().sum()
            for i, p in enumerate(params))
    both = torch.stack([c, -c])
    dist.all_reduce(both, op=dist.ReduceOp.MAX)
    if not bool(both[0] == -both[1]):
        raise RuntimeError("the ranks built different parameters (checksums "
                           f"{float(-both[1])}..{float(both[0])}); build from one seed")


# ---------------------------------------------------------------- batches

PASS_THROUGH = ("n_valid", "uids")


def shard_batch(batch: dict, mesh: Mesh, grad_accum: int = 1) -> dict:
    """This data rank's block of a batch (counterpart of ``batch_shardings``,
    ``mesh.py:81-90``): dim 0, or dim 1 (the micro axis of the ``[accum,
    micro, ...]`` layout) when ``grad_accum > 1``. numpy arrays or tensors;
    ``n_valid`` and ``uids`` pass through. A batch that does not divide
    evenly raises."""
    dim = 1 if grad_accum > 1 else 0
    out = {}
    for k, v in batch.items():
        if k in PASS_THROUGH:
            out[k] = v
            continue
        n = v.shape[dim]
        if n % mesh.n_data:
            raise ValueError(f"shard_batch: {k} has {n} rows on dim {dim}, which do not "
                             f"divide into {mesh.n_data} data ranks")
        b = n // mesh.n_data
        rows = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
        v = v[rows] if dim == 0 else v[:, rows]
        out[k] = v.contiguous() if isinstance(v, torch.Tensor) else np.ascontiguousarray(v)
    return out


def gather_rows(tensors, mesh: Mesh, means=()) -> list:
    """The whole data axis's rows of each tensor, on every data rank, then
    the data-group mean of each tensor of ``means`` (:func:`gather`)."""
    if mesh.n_data == 1:
        return list(tensors) + list(means)
    return gather(tensors, 0, mesh.data_rank, mesh.n_data, mesh.data_group, means)
