"""Fixed-shape batching and a one-ahead device feed (port of
``hriemo/data/batching.py``, one host).

Every batch is padded to a fixed bucket (the training caps), with True in
the pad mask at padded positions, so masking gives the same numbers as
per-batch padding. ``BucketBatcher`` shuffles with the same numpy stream as
JAX's, so the same seed gives the same batches, ``grad_accum`` layout
included. ``native=True`` assembles seq-level batches of ``.npy``/``.npz``
files with the port's C++ loader (``hriemo_torch/native.py``), bit-equal to
the Python loader's; where it cannot (another file format, utter-level
items, no g++), the Python loader runs, and ``BucketBatcher.native`` says
which ran. ``host_shard=(index, count)`` gives each of ``count`` hosts a
disjoint, equally long slice of the one shuffled order, as JAX's does.
"""

from __future__ import annotations

import numpy as np
import torch


def pad_batch(items: list[dict], la: int, lt: int, label_dtype=None) -> dict:
    """Stack seq-level items into fixed ``[B, la]`` / ``[B, lt]`` arrays
    (True = PAD)."""
    b = len(items)
    d_a, d_t = items[0]["h_a"].shape[-1], items[0]["h_t"].shape[-1]
    h_a = np.zeros((b, la, d_a), np.float32)
    h_t = np.zeros((b, lt, d_t), np.float32)
    mask_a = np.ones((b, la), bool)
    mask_t = np.ones((b, lt), bool)
    for i, it in enumerate(items):
        na, nt = min(it["h_a"].shape[0], la), min(it["h_t"].shape[0], lt)
        h_a[i, :na] = it["h_a"][:na]
        h_t[i, :nt] = it["h_t"][:nt]
        mask_a[i, :na] = it["mask_a"][:na]
        mask_t[i, :nt] = it["mask_t"][:nt]
    out = {"h_a": h_a, "h_t": h_t, "mask_a": mask_a, "mask_t": mask_t}
    if "y" in items[0]:
        out["y"] = np.stack([np.asarray(it["y"]) for it in items]).astype(
            label_dtype or np.asarray(items[0]["y"]).dtype)
    return out


def stack_utter_batch(items: list[dict]) -> dict:
    """Stack utter-level items: ``h_a [B, d_a]``, ``h_t [B, d_t]`` fp32 and
    ``y [B]`` int64."""
    return {"h_a": np.stack([it["h_a"] for it in items]).astype(np.float32),
            "h_t": np.stack([it["h_t"] for it in items]).astype(np.float32),
            "y": np.asarray([it["y"] for it in items], np.int64)}


class BucketBatcher:
    """Iterates a dataset in fixed-shape batches.

    * ``drop_last=True`` (training): the partial tail batch is dropped;
    * ``drop_last=False`` (eval): the tail batch repeats its last item and
      ``n_valid`` says how many rows are real;
    * ``grad_accum > 1``: batches have the leading layout ``[accum, micro,
      ...]`` of the train step;
    * ``utter_level``: items are ``[d]`` vectors, stacked as ``[B, 1, d]``
      with all-valid ``[B, 1]`` masks;
    * ``host_shard=(index, count)``: multi-host input
      (``hriemo/data/batching.py:93-137``). Host ``index`` iterates items
      ``index::count`` of the shuffled order, after the order is truncated
      to a multiple of ``count`` (``drop_last``) or wrapped cyclically up
      to one: every host yields the same number of batches, since unequal
      counts would deadlock a collective step.
    """

    def __init__(self, dataset, batch_size: int, la: int = 0, lt: int = 0,
                 shuffle: bool = False, seed: int = 0, drop_last: bool = True,
                 grad_accum: int = 1, utter_level: bool = False, native: bool = False,
                 host_shard: tuple[int, int] | None = None):
        self.ds = dataset
        self.batch_size = batch_size
        self.la, self.lt = la, lt
        self.shuffle, self.seed = shuffle, seed
        self.drop_last = drop_last
        self.grad_accum = grad_accum
        self.utter_level = utter_level
        if host_shard is not None:
            index, count = host_shard
            if not (isinstance(index, int) and isinstance(count, int) and 0 <= index < count):
                raise ValueError(f"host_shard must be (index, count) with 0 <= index < count, "
                                 f"got {host_shard}")
        self.host_shard = host_shard
        self.epoch = 0
        # the C++ loader reads .npy/.npz files of a path-backed seq-level dataset
        self.native = False
        if native and not utter_level and len(dataset) > 0 and hasattr(dataset, "_paths"):
            from .. import native as native_mod

            self.native = all(str(p).endswith((".npy", ".npz"))
                              for pair in dataset._paths for p in pair) \
                and native_mod.is_available()
            if self.native:
                item0 = dataset[0]
                self._native_dims = (item0["h_a"].shape[-1], item0["h_t"].shape[-1])

    def _native_batch(self, idx) -> dict:
        """The batch of items ``idx`` from the C++ loader, with
        :func:`pad_batch`'s keys and dtypes."""
        from .. import native as native_mod

        ds = self.ds
        d_a, d_t = self._native_dims
        h_a, mask_a = native_mod.assemble_modality(
            [str(ds._paths[int(i)][0]) for i in idx], self.la, d_a, max_len=ds.max_len_audio)
        h_t, mask_t = native_mod.assemble_modality(
            [str(ds._paths[int(i)][1]) for i in idx], self.lt, d_t, max_len=ds.max_len_text)
        out = {"h_a": h_a, "h_t": h_t, "mask_a": mask_a, "mask_t": mask_t}
        ys = [ds._labels(ds.rows[int(i)]) for i in idx]
        if ys[0] is not None:
            out["y"] = np.stack([np.asarray(y) for y in ys])
        return out

    def _python_batch(self, items) -> dict:
        if not self.utter_level:
            return pad_batch(items, self.la, self.lt)
        batch = stack_utter_batch(items)
        n = len(items)
        batch["mask_a"] = np.zeros((n, 1), bool)
        batch["mask_t"] = np.zeros((n, 1), bool)
        batch["h_a"] = batch["h_a"][:, None, :]
        batch["h_t"] = batch["h_t"][:, None, :]
        return batch

    def _host_n(self) -> int:
        """Items per host, equal on every host."""
        n = len(self.ds)
        if self.host_shard is None:
            return n
        count = self.host_shard[1]
        return n // count if self.drop_last else -(-n // count)

    def _host_order(self, order: np.ndarray) -> np.ndarray:
        if self.host_shard is None:
            return order
        index, count = self.host_shard
        target = self._host_n() * count
        order = order[:target] if self.drop_last else np.resize(order, target)
        return order[index::count]

    def __len__(self):
        full = self.batch_size * self.grad_accum
        n = self._host_n()
        return n // full if self.drop_last else -(-n // full)

    def __iter__(self):
        order = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        order = self._host_order(order)
        n = len(order)
        self.epoch += 1
        full = self.batch_size * self.grad_accum
        stop = (n // full) * full if self.drop_last else n
        for start in range(0, stop, full):
            idx = order[start: start + full]
            n_valid = len(idx)
            if n_valid < full:  # eval tail: repeat the last item
                idx = np.concatenate([idx, np.full(full - n_valid, idx[-1])])
            if self.native:
                batch = self._native_batch(idx)
                uids = [str(self.ds.rows[int(i)][self.ds.uid_col]) for i in idx[:n_valid]]
            else:
                items = [self.ds[int(i)] for i in idx]
                batch = self._python_batch(items)
                uids = [it.get("uid") for it in items[:n_valid]]
            if self.grad_accum > 1:
                batch = {k: v.reshape((self.grad_accum, self.batch_size) + v.shape[1:])
                         for k, v in batch.items()}
            batch["n_valid"] = n_valid
            batch["uids"] = uids
            yield batch


def prefetch_to_device(iterator, device):
    """Keep one batch in flight: each batch's arrays go to ``device`` as
    tensors (pinned host copies and non-blocking copies to a card) before
    the previous batch is yielded. ``n_valid`` and ``uids`` pass through."""
    device = torch.device(device)
    pin = device.type == "cuda"

    def put(x):
        t = torch.from_numpy(np.ascontiguousarray(x))
        return t.pin_memory().to(device, non_blocking=True) if pin else t.to(device)

    pending = None
    for batch in iterator:
        nxt = {k: (v if k in ("n_valid", "uids") else put(v)) for k, v in batch.items()}
        if pending is not None:
            yield pending
        pending = nxt
    if pending is not None:
        yield pending
