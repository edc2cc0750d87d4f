#!/usr/bin/env python3
"""How far the fusion train step's fp32 gradient moves with the flash forward's rounding.

    python3 chip_grad_flip_probe.py

Run from the repository root: it takes ``chip_smoke.py`` phase 6c's model,
batches and readings. Needs one NVIDIA GPU and ``nvcc``. For the IEMOCAP
decoder at d=768 in 4 heads (hd 192, the wide tiles) and in 8 heads (hd 96,
the narrow ones), fp32, dropout 0, at 2249 and 1499 audio frames, over
several batches (``fusion_batch`` from seeds of its own), it takes the
step's gradients on the plain route (``use_kernels=False``) and on the
flash route with the flash forward computed three ways: by the 3xTF32 tile
kernels (``tiles``), by the CUDA-core kernel in fp32 FMAs (``cuda_cores``,
``cuda_cores=True``), and by the plain version on the card (``plain``: the
route's recompute backward and nothing else). Prints, for each, the loss's
relative error, the whole gradient's relative norm, the FFN ReLU
pre-activations whose sign differs from the plain route's (flips), and the
three leaves with the largest relative norm, by name.
"""

from __future__ import annotations

import math
import subprocess
import sys

import torch

import chip_smoke as C
from hriemo_torch.models import FusionWithEmotionDecoder
from hriemo_torch.ops import _cuda
from hriemo_torch.ops import flash_attention as FA
from hriemo_torch.ops import wavlm_attention as WA
from hriemo_torch.parallel import train_step as TS

# (heads, audio frames, batch seeds)
CASES = ((4, 2249, (0, 1, 2, 3)), (4, 1499, (0, 1)), (8, 2249, (0, 1)))
FORWARDS = {
    "tiles": {},
    "cuda_cores": {
        "onepass_attention": lambda q, k, v, b: WA.onepass_launch(q, k, v, b, cuda_cores=True),
        "streaming_attention": lambda q, k, v, b: FA.streaming_launch(q, k, v, b,
                                                                      cuda_cores=True)},
    "plain": {"onepass_attention": FA.onepass_attention_plain,
              "streaming_attention": FA.streaming_attention_plain},
}


def grads_with_preactivations(model, cfg, batch):
    store, hooks = C.ffn_preactivations(model)
    try:
        loss, grads, _ = TS.compute_grads(model, cfg, batch)
    finally:
        for h in hooks:
            h.remove()
    return loss.item(), grads, dict(store)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_grad_flip_probe: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    _cuda.build_all()
    kernels = {name: getattr(FA, name) for name in ("onepass_attention", "streaming_attention")}
    cfg = TS.TrainConfig(loss_type="multi_label", beta_degeneracy=0.01, schedule="constant",
                         compute_dtype=torch.float32)
    for heads, la, seeds in CASES:
        for seed in seeds:
            model = FusionWithEmotionDecoder(768, 4, heads, 2, 2, 256, dropout=0.0)
            model.init_weights(torch.Generator().manual_seed(C.SEED + 6))
            model = model.to("cuda")
            names = [n for n, _ in model.named_parameters()]
            batch = C.fusion_batch(torch.Generator().manual_seed(100 + seed), la)
            C.set_use_kernels(model, False)
            loss_p, g_p, pre_p = grads_with_preactivations(model, cfg, batch)
            C.set_use_kernels(model, True)
            for forward, fns in FORWARDS.items():
                for name, fn in fns.items():
                    setattr(FA, name, fn)
                try:
                    loss_k, g_k, pre_k = grads_with_preactivations(model, cfg, batch)
                finally:
                    for name, fn in kernels.items():
                        setattr(FA, name, fn)
                leaves, d2, r2 = [], 0.0, 0.0
                for name, g, r in zip(names, g_k, g_p):
                    dn, rn = (g - r).norm().item(), r.norm().item()
                    d2, r2 = d2 + dn * dn, r2 + rn * rn
                    leaves.append((dn / max(rn, 1e-30), name))
                leaves.sort(reverse=True)
                print(f"{heads}x{768 // heads} L={la} batch {seed} {forward:10s}: loss rel "
                      f"{abs(loss_k - loss_p) / abs(loss_p):.3g}, whole {math.sqrt(d2 / r2):.3g}, "
                      f"flips {C.relu_flips(pre_k, pre_p)}, worst leaves "
                      f"{[(f'{x:.3g}', n) for x, n in leaves[:3]]}", flush=True)
            del model
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
