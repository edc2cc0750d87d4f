"""Utilities: weight conversion from the JAX package's flat parameters,
checkpoints (the reference's ``.pt`` layout and mid-run resume), metrics,
step timing and device traces."""
