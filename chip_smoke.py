#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port (``ocflow_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the kernels from ``ocflow_torch/csrc`` with nvcc (sm_90a);
3. record every kernel call of the FlowNetCV serving forward
   (``fast_apply``, 448x1024, B=8) in fp32 and in bf16, replay each through
   the kernel and its plain PyTorch version, and hold them together;
4. drive the serving forward once in bf16 with the launch counters zeroed
   just before and read just after (5 cost volumes, one conv-kernel launch
   per conv of the groups); hold fp32 ``fast_apply`` against the eager fp32
   ``FlowNetCV`` (cuDNN, TF32 off), and bf16 against fp32;
5. time every kernel at the path's shapes against its plain version, its
   bound and a library yardstick, and the forward end to end (pairs/s).

Prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel vs plain version, relative to max |plain|: fp32 differs only in
# summation order; bf16 may differ by a rounding step of the final store
# (and of intermediate stores inside a conv group): two bf16 ulps of the
# largest value
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}
TOL_REASON = {torch.float32: "1e-4 of max|plain|: summation order",
              torch.bfloat16: "2^-6 of max|plain|: two bf16 ulps of rounding"}
# fast_apply fp32 vs eager fp32 (cuDNN, TF32 off), relative to max |eager|:
# summation order through ~30 layers
E2E_FP32_TOL = 1e-4
# fast_apply bf16 vs fp32, relative L2 error: the random-weight network
# amplifies bf16 rounding (0.006-0.014 measured on the CPU plain path at
# 64x128)
E2E_BF16_REL_L2 = 0.05


def _ms(fn, iters: int) -> float:
    """Mean device ms of ``fn`` over ``iters`` calls after one warm-up."""
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


def _record(pwc_fast, model, x):
    """Run ``fast_apply`` once and return the (kind, args) of every kernel
    call it makes, in order."""
    calls = []
    cv, cg = pwc_fast.cost_volume, pwc_fast.conv_group

    def rec_cv(f1, f2, d):
        calls.append(("cost_volume", (f1, f2, d)))
        return cv(f1, f2, d)

    def rec_cg(inputs, group):
        calls.append(("conv_group", (list(inputs), group)))
        return cg(inputs, group)

    pwc_fast.cost_volume, pwc_fast.conv_group = rec_cv, rec_cg
    try:
        pwc_fast.fast_apply(model, x)
    finally:
        pwc_fast.cost_volume, pwc_fast.conv_group = cv, cg
    torch.cuda.synchronize()
    return calls


def _cv_cost(f1):
    b, c, h, w = f1.shape
    nbytes = (2 * b * c * h * w + 81 * b * h * w) * f1.element_size()
    return nbytes, 2 * 81 * b * c * h * w


def _cg_cost(inputs, group, outs):
    b = inputs[0].shape[0]
    ho, wo = outs[0].shape[2:]
    item = inputs[0].element_size()
    nbytes = sum(t.numel() for t in inputs) * item
    nbytes += sum(w.numel() for w in group.weights) * item
    nbytes += sum(o.numel() for o in outs) * item
    flops = sum(2 * w.numel() * b * ho * wo for w in group.weights)
    return nbytes, flops


def _library_conv(inputs, group, stripe_outs):
    """Per spec, F.conv2d over the materialized concat of its reads (the
    blocks taken from a plain run), summed: the cuDNN yardstick."""
    import torch.nn.functional as F

    from ocflow_torch.kernels.conv_chain import conv_group_plain

    # every block of the plain run, for the reads
    emit_all = dataclasses.replace(group, specs=tuple(
        dataclasses.replace(s, emit=True) for s in group.specs))
    blocks = list(inputs) + conv_group_plain(inputs, emit_all)
    calls = []
    for s, w, b in zip(group.specs, group.weights, group.biases):
        xcat = torch.cat([blocks[r] for r in s.reads], 1).contiguous()
        bias = b.to(group.dtype)
        calls.append((xcat, w, bias, s))

    def run():
        for xcat, w, bias, s in calls:
            F.conv2d(xcat, w, bias, stride=s.stride, padding=s.dilation,
                     dilation=s.dilation)

    return run


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from ocflow_torch.bench import (BATCH, HEIGHT, SEED, WIDTH, gpu_info,
                                    make_inputs, measure)
    from ocflow_torch.kernels import _build
    from ocflow_torch.kernels import conv_chain, cost_volume as cv_mod
    from ocflow_torch.models import pwc_fast

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = gpu_info()
    print(card)  # name, power limit: the line nvidia-smi gives

    # 2. build
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s wall; " + ", ".join(
        f"{k} {v['seconds']:.2f} s" for k, v in built.items()))

    model, x32 = make_inputs(BATCH, HEIGHT, WIDTH, torch.float32, "cuda", SEED)
    model.eval()
    xb = x32.bfloat16()

    # 3. every kernel call of the path, kernel vs plain, fp32 and bf16
    max_err = {"cost_volume": 0.0, "conv_group": 0.0}
    recorded = {}
    for dtype, x in ((torch.float32, x32), (torch.bfloat16, xb)):
        calls = _record(pwc_fast, model, x)
        recorded[dtype] = calls
        for kind, args in calls:
            if kind == "cost_volume":
                got = [cv_mod.cost_volume(*args)]
                ref = [cv_mod.cost_volume_plain(*args)]
                shape = tuple(args[0].shape)
            else:
                got = conv_chain.conv_group(*args)
                ref = conv_chain.conv_group_plain(*args)
                shape = tuple(args[0][0].shape)
            torch.cuda.synchronize()
            err = max((g.float() - r.float()).abs().max().item()
                      for g, r in zip(got, ref))
            scale = max(r.float().abs().max().item() for r in ref)
            tol = KERNEL_TOL[dtype] * max(scale, 1e-6)
            print(f"check {kind} {str(dtype)[6:]} {shape}: max_abs_err "
                  f"{err:.3e} rel {err / max(scale, 1e-6):.3e} max|plain| "
                  f"{scale:.3e} tol {tol:.3e} ({TOL_REASON[dtype]})")
            if not err <= tol:
                raise AssertionError(f"{kind} {shape} {dtype}: {err} > {tol}")
            max_err[kind] = max(max_err[kind], err)

    # 4. the main path, bf16, counters zeroed just before
    fw = pwc_fast.prepare(model, torch.bfloat16, torch.device("cuda"))
    want_cg = sum(len(g.specs) for g in fw.groups())
    cv_mod.cost_volume.launches = 0
    conv_chain.conv_group.launches = 0
    out_b = pwc_fast.fast_apply(model, xb)
    torch.cuda.synchronize()
    launches = {"cost_volume": cv_mod.cost_volume.launches,
                "conv_group": conv_chain.conv_group.launches}
    print(f"main path launches: {launches} (expected cost_volume 5, "
          f"conv_group {want_cg})")
    if launches != {"cost_volume": 5, "conv_group": want_cg}:
        raise AssertionError(f"launch counts {launches}")

    out_f = pwc_fast.fast_apply(model, x32)
    with torch.no_grad():
        ref = model(x32)
    torch.cuda.synchronize()
    for name, r, f, b in zip(("full", "quarter"), ref, out_f, out_b):
        want = (BATCH, HEIGHT, WIDTH, 2) if name == "full" else (
            BATCH, HEIGHT // 4, WIDTH // 4, 2)
        for t in (f, b):
            if tuple(t.shape) != want or t.dtype != torch.float32 \
                    or not torch.isfinite(t).all():
                raise AssertionError(f"{name}: bad output {t.shape} {t.dtype}")
        scale = r.abs().max().item()
        err32 = (f - r).abs().max().item()
        rel_b = ((b - r).norm() / r.norm()).item()
        errb = (b - r).abs().max().item()
        print(f"e2e {name}: fp32 fast vs eager max_abs_err {err32:.3e} "
              f"(tol {E2E_FP32_TOL * scale:.3e}, max|eager| {scale:.3e}); "
              f"bf16 vs fp32 rel_l2 {rel_b:.4f} (tol {E2E_BF16_REL_L2}) "
              f"max_abs_err {errb:.3e}")
        if not err32 <= E2E_FP32_TOL * scale:
            raise AssertionError(f"fp32 fast_apply vs eager: {err32}")
        if not rel_b <= E2E_BF16_REL_L2:
            raise AssertionError(f"bf16 vs fp32 rel_l2 {rel_b}")

    # 5. timing, bf16 (the serving path), beside the card on the line above
    per = {k: {"ms": 0.0, "plain_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
               "bound_ms": 0.0, "library_ms": 0.0}
           for k in ("cost_volume", "conv_group")}
    dt = torch.bfloat16
    for kind, args in recorded[dt]:
        if kind == "cost_volume":
            k_ms = _ms(lambda: cv_mod.cost_volume(*args), 20)
            p_ms = _ms(lambda: cv_mod.cost_volume_plain(*args), 3)
            nbytes, flops = _cv_cost(args[0])
            lib_ms = None
            shape = tuple(args[0].shape)
        else:
            outs = conv_chain.conv_group(*args)
            k_ms = _ms(lambda: conv_chain.conv_group(*args), 5)
            p_ms = _ms(lambda: conv_chain.conv_group_plain(*args), 3)
            lib_ms = _ms(_library_conv(*args, outs), 5)
            nbytes, flops = _cg_cost(*args, outs)
            shape = tuple(args[0][0].shape)
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        o_ms = flops / PEAK_FLOPS[dt] * 1e3
        bound = max(b_ms, o_ms)
        p = per[kind]
        p["ms"] += k_ms
        p["plain_ms"] += p_ms
        p["bytes_ms"] += b_ms
        p["ops_ms"] += o_ms
        p["bound_ms"] += bound
        if lib_ms is not None:
            p["library_ms"] += lib_ms
        print(f"time {kind} bf16 {shape}: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, library {lib_ms if lib_ms is None else round(lib_ms, 4)} ms, "
              f"bound {bound:.4f} ms ({'bytes' if b_ms >= o_ms else 'operations'}; "
              f"{nbytes} B, {flops} flop) [{card}]")

    e2e = measure(model.bfloat16(), xb)
    print(f"e2e bf16 fast_apply B={BATCH} {HEIGHT}x{WIDTH}: "
          f"{e2e['ms_per_batch']:.3f} ms/batch, {e2e['pairs_per_sec']:.2f} "
          f"pairs/s [{card}]")

    meta = {
        "cost_volume": ("ocflow_torch/csrc/cost_volume.cu",
                        "ocflow_tpu/ops/pallas/cost_volume_kernel.py:91"),
        "conv_group": ("ocflow_torch/csrc/conv_group.cu",
                       "ocflow_tpu/ops/pallas/conv_chain_kernel.py:463"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        p = per[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max_err[name], "ms": p["ms"],
            "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"],
            "bound_by": "bytes" if p["bytes_ms"] >= p["ops_ms"] else "operations",
            "library_ms": p["library_ms"] if name == "conv_group" else None,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
