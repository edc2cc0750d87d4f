"""Ranks and process groups: the port's counterpart of the JAX package's
single-process device runtime.

JAX drives every device of a mesh from one process. PyTorch runs one
process per rank, each with its device, and process groups stand in for the
mesh axes (``mesh.py``). :func:`spawn` starts the ranks of one run and
returns what each returned; under ``torchrun`` (``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK`` set) it joins the group the launcher made instead.

The backend follows from the layout:

* NCCL when every rank of a host has a card of its own;
* gloo on the CPU;
* gloo with CUDA tensors when ranks share a card (NCCL does not put two
  ranks on one device). That case supports ``all_reduce`` and ``broadcast``
  only, so the collectives of the train and eval steps are those two.

Rank ``r`` takes card ``r % torch.cuda.device_count()``. Worker functions
must be importable by module path (a spawned child imports the module of
its target), and a rank's result is pickled by value, so return CPU tensors
or plain data.
"""

from __future__ import annotations

import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TORCHRUN_VARS = ("WORLD_SIZE", "RANK", "LOCAL_RANK")


def under_torchrun() -> bool:
    return all(k in os.environ for k in TORCHRUN_VARS)


def rank_device(local_rank: int, device) -> torch.device:
    """The device of a rank: card ``local_rank % device_count`` for a CUDA
    run, else the CPU."""
    if torch.device(device).type != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def backend_for(local_world: int, device) -> str:
    """``nccl`` when each of a host's ``local_world`` ranks has a card of
    its own, else ``gloo``."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def init_distributed(rank: int, world_size: int, init_method: str, device) -> torch.device:
    """Join the process group as ``rank`` of ``world_size`` and return this
    rank's device (made current for a card). Under torchrun the local rank
    and the host's rank count come from ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE``. Rank 0 prints the backend and the rank-to-device
    map on one line."""
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    dev = rank_device(local_rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend_for(local_world, device)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank)
    if rank == 0:
        where = ", ".join(f"{r}->{rank_device(r % local_world, device)}"
                          for r in range(world_size))
        print(f"[dist] backend {backend}, {world_size} ranks: {where}", flush=True)
    return dev


def _child(fn, rank, n, init_method, device, threads, args, results):
    """One spawned rank: join the group, run ``fn(device, *args)``, post
    ``(rank, ok, pickled result or traceback)``."""
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = init_distributed(rank, n, init_method, device)
        results.put((rank, True, pickle.dumps(fn(dev, *args))))
    except BaseException:  # noqa: BLE001 - reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, n: int, device, *args, timeout: float | None = None) -> list:
    """Run ``fn(rank_device, *args)`` on ``n`` ranks and return the list of
    their results in rank order.

    Without torchrun, ``n`` child processes start in the ``spawn`` context
    and meet at a ``file://`` store in a temporary directory (no TCP port:
    concurrent runs on one host cannot collide). On the CPU each rank gets
    ``max(1, threads // n)`` of the caller's threads. A rank that raises, or
    dies without a result, makes ``spawn`` stop the others and raise
    ``RuntimeError`` with its traceback; so does ``timeout`` (seconds).

    Under torchrun this process is one rank: it joins the launcher's group
    (``env://``), runs ``fn`` and returns ``[its result]``."""
    if under_torchrun():
        dev = init_distributed(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                               "env://", device)
        try:
            return [fn(dev, *args)]
        finally:
            dist.destroy_process_group()

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store = tempfile.mkdtemp(prefix="hriemo_dist_")
    init_method = "file://" + os.path.join(store, "rendezvous")
    threads = max(1, torch.get_num_threads() // n) if torch.device(device).type == "cpu" else 0
    procs = [ctx.Process(target=_child, args=(fn, r, n, init_method, device, threads, args,
                                              results)) for r in range(n)]
    got, error = {}, None
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(got) < n and error is None:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in got and p.exitcode not in
                        (None, 0)]
                if dead:
                    error = f"rank {dead[0]} exited with code {procs[dead[0]].exitcode}"
                elif all(p.exitcode is not None for p in procs):
                    error = "every rank exited, some without a result"
                elif deadline is not None and time.monotonic() > deadline:
                    error = f"the ranks did not finish within {timeout} s"
                continue
            if ok:
                got[rank] = pickle.loads(payload)
            else:
                error = f"rank {rank} failed:\n{payload}"
    finally:
        for p in procs:
            if error is not None and p.is_alive():
                p.terminate()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
        shutil.rmtree(store, ignore_errors=True)
    if error is not None:
        raise RuntimeError(f"spawn({getattr(fn, '__name__', fn)}, {n}): {error}")
    return [got[r] for r in range(n)]
