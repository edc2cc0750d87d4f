#!/usr/bin/env python3
"""Per-bucket products of one served forward (port of
``tools/bucket_flops.py``).

For each audio bucket of ``hriemo_torch.bench`` at its text bucket and its
batch from ``MEASURED_BUCKET_BATCH``: the analytic operation count of one
W8A8 forward (:mod:`hriemo_torch.utils.flops`), split by the dtype each
product runs in, and the least time the H100's compute could take for it.
The count takes no time, so no artifact is kept: the bench computes it live
for its ``mfu``. These counts leave out elementwise work and the Gram
GroupNorm statistics, so they are not comparable with ``bucket_flops.json``
(XLA's counts of the JAX forward).

    python -m hriemo_torch.tools.bucket_flops

Needs no card.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..bench import BUCKET_LT, BUCKETS_S, SR, serving_configs
from ..infer.streaming import MEASURED_BUCKET_BATCH
from ..utils.flops import served_products


def main(argv=None) -> list[dict]:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)
    wcfg, bcfg, fusion = serving_configs()
    print("# one W8A8 forward a bucket: operations by dtype, bound at the H100 SXM peaks",
          flush=True)
    rows = []
    for sec in BUCKETS_S:
        batch, lt = MEASURED_BUCKET_BATCH[sec], BUCKET_LT[sec]
        p = served_products(wcfg, bcfg, fusion, batch, int(sec * SR), lt)
        rows.append(dict(seconds=sec, batch=batch, lt=lt, ops=p.by_dtype(), total=p.total,
                         bound_ms=p.bound_s() * 1e3))
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
    sys.exit(0)
