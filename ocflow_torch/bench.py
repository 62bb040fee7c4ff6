"""Serving benchmark of the port: FlowNetCV ``fast_apply`` pairs/s.

Runs 448x1024, batch 8, bf16 weights and input, random weights from a
seed; warms up, then times 20 forwards with CUDA events. Prints one
JSON line::

    {"metric": "flownetcv_448x1024_bf16_inference", "value": N,
     "unit": "pairs/sec/chip", "ms_per_batch": t, "batch": 8,
     "device": {"name": ..., "power_limit": ...}}

Usage: ``python -m ocflow_torch.bench [--device cuda]``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from ocflow_torch import resolve_device
from ocflow_torch.models.pwc_fast import fast_apply
from ocflow_torch.models.pwc_net import FlowNetCV

# the serving shape of the JAX package's bench.py: Sintel-padded, batch 8
BATCH, HEIGHT, WIDTH, SEED = 8, 448, 1024, 0
ITERS, WARMUP = 20, 3


def gpu_info() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
    them (first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def make_inputs(batch: int, height: int, width: int, dtype, device,
                seed: int = 0):
    """Seeded random FlowNetCV and a ``[B, H, W, 6]`` input in [-1, 1]."""
    gen = torch.Generator().manual_seed(seed)
    model = FlowNetCV(generator=gen).to(device=device, dtype=dtype)
    x = torch.rand((batch, height, width, 6), generator=gen) * 2 - 1
    return model, x.to(device=device, dtype=dtype)


def measure(model, x, iters: int = ITERS, warmup: int = WARMUP) -> dict:
    """Mean ms per ``fast_apply`` call over ``iters`` calls after
    ``warmup``, timed with CUDA events on the card (host clock on the CPU).
    """
    for _ in range(warmup):
        fast_apply(model, x, device=x.device)
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fast_apply(model, x, device=x.device)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            fast_apply(model, x, device=x.device)
        ms = (time.perf_counter() - t0) * 1e3 / iters
    return {"ms_per_batch": ms, "pairs_per_sec": x.shape[0] * 1e3 / ms}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    model, x = make_inputs(BATCH, HEIGHT, WIDTH, torch.bfloat16, dev, SEED)
    res = measure(model, x)
    if dev.type == "cuda":
        name, _, limit = gpu_info().partition(", ")
        device = {"name": name, "power_limit": limit}
    else:
        device = {"name": "cpu", "power_limit": None}
    result = {
        "metric": f"flownetcv_{HEIGHT}x{WIDTH}_bf16_inference",
        "value": res["pairs_per_sec"],
        "unit": "pairs/sec/chip" if dev.type == "cuda" else "pairs/sec/cpu",
        "ms_per_batch": res["ms_per_batch"],
        "batch": BATCH,
        "device": device,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
