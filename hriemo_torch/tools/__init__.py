"""Command-line tools of the port (counterparts of the repo's ``tools/``):
``kernel_numerics``, ``validate_pretrained_bridges`` and the MOSEI tools."""
