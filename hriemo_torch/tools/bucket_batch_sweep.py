#!/usr/bin/env python3
"""Search each audio bucket's flush batch on the card: the readings behind
``infer/streaming.py::MEASURED_BUCKET_BATCH`` (the counterpart of the JAX
package's batch sweeps, ``bench.py:128-136``).

For each of ``hriemo_torch.bench``'s audio buckets at its text bucket, the
served W8A8 forward (random weights from ``--seed``) is captured as a CUDA
graph at each batch of :data:`BATCHES` in turn and timed as the bench times a
bucket (:func:`hriemo_torch.bench.measure`: median of five samples of ten
replays); ms per utterance ranks the batches. Where two come within 1%, the
smaller one is kept, for flush latency. A bucket stops growing its batch
after an out-of-memory error or once two batches in a row read more than 3%
above the best so far.

    python3 -m hriemo_torch.tools.bucket_batch_sweep [--buckets 2.5 10]

Prints one JSON line a reading and the chosen table last; the readings go
to ``chip_smoke_out/bucket_batch_sweep_h100.json``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np
import torch

from .. import bench
from ..device import resolve_device

BATCHES = (32, 64, 128, 192, 256, 384, 512, 768, 1024)
TIE = 0.01    # batches within 1% of the best tie; the smaller one is kept
STOP = 0.03   # two batches in a row this far above the best end a bucket's search


def pick(readings: dict) -> int:
    """The smallest batch within :data:`TIE` of the least ms per
    utterance; ``readings`` maps batch -> ms per utterance (None: failed)."""
    ok = {b: v for b, v in readings.items() if v is not None}
    best = min(ok.values())
    return min(b for b, v in ok.items() if v <= best * (1 + TIE))


def sweep_bucket(pipe, sec: float, batches, rng) -> dict:
    """``{batch: ms per utterance or None}`` at one bucket, in ascending
    batch order until the search stops."""
    readings, worse = {}, 0
    for b in batches:
        try:
            m = bench.measure(pipe, b, sec, rng)
        except torch.cuda.OutOfMemoryError:
            readings[b] = None
            print(json.dumps(dict(seconds=sec, batch=b, error="out of memory")), flush=True)
            break
        finally:
            pipe.release_graphs()
            torch.cuda.empty_cache()
        readings[b] = m["ms_per_utt"]
        print(json.dumps(dict(seconds=sec, **{k: v for k, v in m.items() if k != "ops"})),
              flush=True)
        best = min(v for v in readings.values() if v is not None)
        worse = worse + 1 if m["ms_per_utt"] > best * (1 + STOP) else 0
        if worse == 2:
            break
    return readings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--buckets", type=float, nargs="+", default=list(bench.BUCKETS_S))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default="chip_smoke_out/bucket_batch_sweep_h100.json")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    from ..ops import _cuda

    _cuda.build_all()
    card = bench.card()
    print(card, flush=True)
    pipe = bench.serving_pipeline(bench.build_serving_models(args.seed), dev)
    rng = np.random.default_rng(args.seed)
    readings, table = {}, {}
    for sec in args.buckets:
        readings[sec] = sweep_bucket(pipe, sec, BATCHES, rng)
        table[sec] = pick(readings[sec])
        print(f"# {sec} s: batch {table[sec]}", file=sys.stderr, flush=True)
    path = pathlib.Path(args.json)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(dict(card=card, seed=args.seed, tie=TIE,
                                    readings={str(s): {str(b): v for b, v in r.items()}
                                              for s, r in readings.items()},
                                    table={str(s): b for s, b in table.items()}), indent=1))
    print(json.dumps({"MEASURED_BUCKET_BATCH": {str(s): b for s, b in table.items()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
