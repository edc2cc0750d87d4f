"""Shared training utilities (port of ``hriemo/train/common.py``)."""

from __future__ import annotations

import csv
import random
from pathlib import Path

import numpy as np
import torch

from ..nn.layers import fold_in


def set_seed(seed: int) -> None:
    """Seed the host RNGs. Model init, shuffling and dropout draw from
    explicit generators and seeds of their own."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def dropout_seed(seed: int) -> int:
    """The run's base seed of the training step's dropout stream (the
    counterpart of ``dropout_key``: any valid Bernoulli stream is a correct
    mask, so the bits need not match JAX's)."""
    return fold_in(seed, 0x64726F70)


def step_generator(base_seed: int, data: int, device) -> torch.Generator:
    """The generator of one train step, from the run's dropout seed and
    ``data`` (the trainers pass ``epoch * 100000 + i``, as their ``fold_in``
    does); the step derives each micro-batch's from it."""
    return torch.Generator(torch.device(device)).manual_seed(fold_in(base_seed, data))


class TrainLogWriter:
    """Writes ``outputs/train_log.csv`` (epoch, train_loss, val_loss, ...)."""

    def __init__(self, path: str | Path, fields: list[str]):
        self.path = Path(path)
        self.fields = fields
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with open(self.path, "w", newline="") as f:
            csv.DictWriter(f, fieldnames=fields).writeheader()

    def append(self, **row):
        with open(self.path, "a", newline="") as f:
            csv.DictWriter(f, fieldnames=self.fields).writerow(
                {k: row.get(k, "") for k in self.fields})


def maybe_synthetic_mosei(args):
    """With ``--synthetic N``, write a corpus under ``out_dir`` and point the
    data flags at it."""
    if getattr(args, "synthetic", 0):
        from ..data.synthetic import make_synthetic_mosei

        root = Path(args.out_dir) / "synthetic_data"
        csv_path, audio_dir, text_dir = make_synthetic_mosei(root, n=args.synthetic,
                                                             seed=args.seed)
        args.index_csv, args.audio_dir, args.text_dir = str(csv_path), str(audio_dir), str(text_dir)
    return args


def maybe_synthetic_iemocap(args, seq_level: bool):
    if getattr(args, "synthetic", 0):
        from ..data.synthetic import make_synthetic_iemocap

        root = Path(args.out_dir) / "synthetic_data"
        csv_path, audio_dir, text_dir = make_synthetic_iemocap(
            root, n=args.synthetic, d=args.d_model, seq_level=seq_level, seed=args.seed)
        args.index_csv, args.audio_dir, args.text_dir = str(csv_path), str(audio_dir), str(text_dir)
    return args
