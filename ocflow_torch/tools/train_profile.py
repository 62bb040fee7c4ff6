"""Where the bf16 training step's time goes on the card.

Runs the ``longrun_synthetic.yaml`` step (``bench.make_train_inputs``:
FlowNetCV, 448x1024, B=8, seed 0) and prints one JSON line with:

- ``ms_per_step``: device ms per step (CUDA events over ``--steps`` steps
  after 3 warm-up steps), and ``host_ms_per_step``, the host's time to issue
  a step (the step never waits for the device, so a host time near the
  device time means the host paces the card);
- ``parts``: device ms between the step's timing marks (encoder, forward
  decode, backward decode, occlusion, losses, backward, optimizer);
- ``kernel_ms_per_step`` and ``busy_share``: the device time of every
  kernel in a ``torch.profiler`` trace of the same steps, per step and as a
  share of the steps' device time (the rest is the card waiting for work);
  ``top``: the kernels with the most device time.

Usage: ``python -m ocflow_torch.tools.train_profile [--steps 5]``.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ocflow_torch import resolve_device
from ocflow_torch.bench import (BATCH, HEIGHT, SEED, WIDTH, gpu_info, make_train_inputs,
                                train_hparams)


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def step_parts(steps: int, warmup: int = 3, device="cuda"):
    """Device ms between the bf16 step's timing marks (CUDA events at the
    step's ``_mark`` hooks), mean of ``steps`` steps after ``warmup``, each
    step followed by a synchronize. Returns ``(parts, state, train_step,
    batch)``: the step keeps recording its marks."""
    dev = resolve_device(device)
    marks = []

    def mark(name):
        marks.append((name, torch.cuda.Event(enable_timing=True)))
        marks[-1][1].record()

    state, step, batch = make_train_inputs(BATCH, HEIGHT, WIDTH, dev, SEED,
                                           {**train_hparams(), "_mark": mark})
    for _ in range(warmup):
        step(state, batch)
    torch.cuda.synchronize()
    parts = {}
    for _ in range(steps):
        marks.clear()
        mark("start")
        step(state, batch)
        torch.cuda.synchronize()
        for (_, a), (name, b) in zip(marks, marks[1:]):
            parts[name] = parts.get(name, 0.0) + a.elapsed_time(b) / steps
    return parts, state, step, batch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    parts, state, step, batch = step_parts(args.steps)
    # steps back to back, as training runs them
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    for _ in range(args.steps):
        step(state, batch)
    end.record()
    host_unsplit = (time.perf_counter() - t0) * 1e3 / args.steps
    end.synchronize()
    ms = start.elapsed_time(end) / args.steps

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(args.steps):
            step(state, batch)
        end.record()
        end.synchronize()
    traced_ms = start.elapsed_time(end) / args.steps
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA") and _device_us(e) > 0]
    kernel_ms = sum(_device_us(e) for e in kernels) / 1e3 / args.steps
    top = sorted(kernels, key=_device_us, reverse=True)[:12]
    name, _, limit = gpu_info().partition(", ")
    result = {
        "ms_per_step": ms, "host_ms_per_step": host_unsplit, "parts": parts,
        "traced_ms_per_step": traced_ms, "kernel_ms_per_step": kernel_ms,
        "busy_share": kernel_ms / traced_ms if traced_ms else None,
        "top": [{"name": e.key[:80], "ms_per_step": _device_us(e) / 1e3 / args.steps,
                 "calls_per_step": e.count / args.steps} for e in top],
        "batch": BATCH, "device": {"name": name, "power_limit": limit},
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
