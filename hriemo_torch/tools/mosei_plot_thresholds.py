#!/usr/bin/env python3
"""Bar plot of a checkpoint's calibrated thresholds (port of
``tools/mosei_plot_thresholds.py``). matplotlib is imported in ``main``.

    python -m hriemo_torch.tools.mosei_plot_thresholds --ckpt best.pt --out figs/thresholds.png
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..data.synthetic import MOSEI_EMO_COLS

EMO_COLS = [c.replace("emo_", "") for c in MOSEI_EMO_COLS]


def main(argv=None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..utils.checkpoint import load_torch_checkpoint

    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", type=str, required=True)
    ap.add_argument("--out", type=str, default="figs/thresholds.png")
    args = ap.parse_args(argv)

    ths = load_torch_checkpoint(args.ckpt).get("val_calibrated_thresholds")
    if ths is None:
        raise SystemExit("checkpoint has no val_calibrated_thresholds")
    ths = np.asarray(ths)

    fig, ax = plt.subplots(figsize=(6, 4))
    ax.bar(range(len(ths)), ths)
    ax.set_xticks(range(len(ths)), EMO_COLS[: len(ths)], rotation=30)
    ax.set_ylabel("calibrated threshold")
    fig.tight_layout()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out, dpi=120)
    plt.close(fig)
    print(f"[Saved] {out}")
    return out


if __name__ == "__main__":
    main()
