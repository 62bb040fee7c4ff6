"""Serving benchmark of the port: FlowNetCV ``fast_apply`` pairs/s.

Runs 448x1024, batch 8, bf16 weights and input, random weights from a
seed; warms up, then times 20 forwards with CUDA events. Prints one
JSON line::

    {"metric": "flownetcv_448x1024_bf16_inference", "value": N,
     "unit": "pairs/sec/chip", "ms_per_batch": t, "batch": 8,
     "device": {"name": ..., "power_limit": ...}}

With ``--q8`` the decoders run W8A8, with scales from ``calibrate_q8`` on a
held-out batch (seed 1), and the metric is
``flownetcv_448x1024_w8a8_inference``.

Usage: ``python -m ocflow_torch.bench [--q8] [--device cuda]``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from ocflow_torch import resolve_device
from ocflow_torch.models.pwc_fast import calibrate_q8, fast_apply
from ocflow_torch.models.pwc_net import FlowNetCV

# the serving shape of the JAX package's bench.py: Sintel-padded, batch 8
BATCH, HEIGHT, WIDTH, SEED = 8, 448, 1024, 0
CALIB_SEED = 1  # the held-out W8A8 calibration batch, as the JAX bench
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


def calibration_batch(like: torch.Tensor, seed: int = CALIB_SEED) -> torch.Tensor:
    """A held-out batch of ``like``'s shape, dtype and device, uniform in
    [-1, 1] from ``seed`` (calibrating on the measured batch would flatter
    the accuracy)."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand(like.shape, generator=gen) * 2 - 1
    return x.to(device=like.device, dtype=like.dtype)


def cuda_ms(fn, iters: int) -> float:
    """Mean device ms of ``fn`` over ``iters`` calls after one warm-up,
    timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def measure(model, x, q8=None, iters: int = ITERS, warmup: int = WARMUP) -> dict:
    """Mean ms per ``fast_apply`` call over ``iters`` calls after
    ``warmup``, timed with CUDA events on the card (host clock on the CPU).
    """
    def run():
        fast_apply(model, x, q8=q8, device=x.device)

    for _ in range(warmup):
        run()
    if x.device.type == "cuda":
        ms = cuda_ms(run, iters)
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        ms = (time.perf_counter() - t0) * 1e3 / iters
    return {"ms_per_batch": ms, "pairs_per_sec": x.shape[0] * 1e3 / ms}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--q8", action="store_true",
                    help="W8A8 decoders, scales calibrated on a held-out batch")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    model, x = make_inputs(BATCH, HEIGHT, WIDTH, torch.bfloat16, dev, SEED)
    q8 = calibrate_q8(model, calibration_batch(x), device=dev) if args.q8 else None
    res = measure(model, x, q8)
    if dev.type == "cuda":
        name, _, limit = gpu_info().partition(", ")
        device = {"name": name, "power_limit": limit}
    else:
        device = {"name": "cpu", "power_limit": None}
    result = {
        "metric": f"flownetcv_{HEIGHT}x{WIDTH}_{'w8a8' if args.q8 else 'bf16'}_inference",
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
