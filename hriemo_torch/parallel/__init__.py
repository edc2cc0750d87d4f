"""The train and eval steps (single device; the mesh waits for ROADMAP.md
queue 1 item 8)."""

from .train_step import (TrainConfig, TrainState, apply_update, compute_grads, compute_loss,
                         create_train_state, make_eval_step, make_schedule, make_train_step)

__all__ = ["TrainConfig", "TrainState", "apply_update", "compute_grads", "compute_loss", "create_train_state",
           "make_eval_step", "make_schedule", "make_train_step"]
