"""The train and eval steps, on one device or over the ``(data, model)``
mesh on ``torch.distributed`` (``launch.py`` starts the ranks,
``mesh.py`` lays them out and shards the FFNs, ``sequence_parallel.py``
has ring attention)."""

from .mesh import (DATA_AXIS, MODEL_AXIS, Mesh, make_mesh, param_shardings, shard_batch,
                   shard_params)
from .train_step import (TrainConfig, TrainState, apply_update, compute_grads, compute_loss,
                         create_train_state, make_eval_step, make_schedule, make_train_step,
                         shard_train_state)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "make_mesh", "param_shardings", "shard_batch",
           "shard_params", "TrainConfig", "TrainState", "apply_update", "compute_grads",
           "compute_loss", "create_train_state", "make_eval_step", "make_schedule",
           "make_train_step", "shard_train_state"]
