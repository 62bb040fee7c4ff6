#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port (``ocflow_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the kernels from ``ocflow_torch/csrc`` with nvcc (sm_90a), one
   nvcc per source, all started together;
3. record every kernel call of the FlowNetCV serving forward
   (``fast_apply``, 448x1024, B=8) in fp32 and in bf16, replay each through
   the kernel and its plain PyTorch version, and hold them together;
4. calibrate W8A8 scales on a held-out batch (seed 1), record every kernel
   call of the W8A8 forward and of the opt-in forward (encoder and context
   chain int8 too), and replay each against its plain version: int8 codes
   and the bf16 outputs of int8-read convs bit for bit, bf16-read convs and
   the bf16 conv groups within 2^-6, cost volumes as in phase 3;
5. drive each path once with every launch counter zeroed just before and
   read just after: the bf16 forward (5 cost volumes, one bf16 conv launch
   per conv), the W8A8 forward (5, 24, 35 int8 launches) and the GEMM
   probe ``ocflow_torch.tools.spike_int8`` (2048^3, int8 exact, bf16 within
   1e-2);
6. hold fp32 ``fast_apply`` against the eager fp32 ``FlowNetCV`` (cuDNN,
   TF32 off), bf16 against fp32, W8A8 against the eager fp32 forward;
7. time every kernel at the path's shapes against its plain version, its
   bound and a library yardstick, and the bf16 and W8A8 forwards end to
   end (pairs/s) in turns;
8. training (``longrun_synthetic.yaml`` hparams, seeded FlowNetCV and
   smooth seeded frames, 448x1024, B=8): record every kernel call of one
   fp32 and one bf16 step (pair + loss + backward) and replay each against
   its plain version (cost-volume forward and backward, serving conv
   groups, ``conv_group_diff`` forwards); hold the fused fp32 step against
   the eager fp32 step (loss, metrics, per-tensor gradients, parameters
   after Adam) beside what the gap is made of (each step's run-to-run
   spread, the eager step with deterministic cuDNN, the eager step with
   the fused run's occlusion mask held); bf16 vs fp32
   gradients; launches of one bf16 step (10 cost volumes, 5 backward, 31
   ``conv_group_diff`` conv launches, 72 conv launches in all) and of one
   with a W8A8 backward decode (37 and 35 int8); five bf16 Adam steps;
   the bf16 step end to end, and the new kernels' calls against plain,
   bound and cuDNN.

Prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12}
# kernel vs plain version, relative to max |plain|: fp32 differs only in
# summation order; bf16 may differ by a rounding step of the final store
# (and of intermediate stores inside a conv group): two bf16 ulps of the
# largest value. The int8 kernel is exact (integer sums, the same fp32
# epilogue operations in the same order): no tolerance.
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
# W8A8 fast_apply vs the eager fp32 forward, quarter-flow max-abs relative
# to max |flow_quarter|. The JAX package's bounds (0.05 decoders,
# tests/test_pwc_fast.py:546; 0.1 with the encoder and context chain, :673)
# hold its tests' small shape; this random-weight net at full size is
# noisier while every int8 call equals its plain version bit for bit. The
# plain path on the CPU at the largest shape it runs in a minute
# (`python -m ocflow_torch.tools.q8_error --batch 4 --dtype float32
# --device cpu`, 4x448x1024) measures 0.079 and 0.108; the bounds round
# those up by a quarter to a third.
E2E_Q8_TOL = {"w8a8": 0.1, "w8a8_enc_ctx": 0.15}
# training, one Adam step at 448x1024 B=8 fp32 (TF32 off), the fused step
# vs the eager step (fast_forward='off'), same weights and batch. Neither
# step is deterministic (the range-map splat's index_add_, the warps'
# scatter-add backward and cuDNN's backward add with atomics). Gradients
# are sums of many cancelling terms, so summation order moves them far
# more than it moves the activations. Measured on the H100 (the witnesses
# this phase prints), max-abs over max|grad| in the worst tensor: the fused
# step run to run 3.4e-3-8.1e-3, the eager step run to run 1.6e-2-1.65e-2,
# the eager step against itself with cuDNN's deterministic algorithms
# 4.7e-3-1.47e-2, fused vs eager 2.6e-2-3.5e-2 over five runs (2.5e-2-3.1e-2
# with the fused run's occlusion mask held in the eager step), always on a
# bias (deconv5, conv6); the whole gradient's relative L2 moves up to
# 1.2e-3 (fused), 2.0e-3 (eager) and 1.6e-3-3.0e-3 between them. Metrics
# agree to 2e-7-2.0e-6.
# The bounds are ~1.7x the largest fused-vs-eager reading and ~3.5x the
# eager step's own spread:
TRAIN_METRIC_REL = 1e-4      # loss and every metric, relative
TRAIN_GRAD_REL_L2 = 0.06     # per parameter tensor, relative L2
TRAIN_GRAD_MAX_REL = 0.06    # per parameter tensor, max-abs over max|grad|
TRAIN_GRAD_GLOBAL = 6e-3     # the whole gradient, relative L2
# a sanity check only (the step ran with the same lr on the same weights):
# Adam's first step moves each weight by about lr = 1e-4 whatever |grad|,
# so two runs differ by at most 2 lr, a sign flip of a near-zero gradient
TRAIN_PARAM_ATOL = 5e-4
# bf16 step vs fp32 step, relative L2 of the whole gradient: bf16 rounding
# through a random-weight network (0.122 measured on the H100; per tensor
# median 0.21, up to 0.93 on tensors whose gradient is near zero)
TRAIN_BF16_REL_L2 = 0.2


# kernels with no single PyTorch call computing the same function
NO_LIBRARY = {
    "cost_volume": "no single PyTorch call computes a local correlation",
    "cost_volume_bwd": "no single PyTorch call computes its adjoint",
    "conv_group_q8": "PyTorch has no int8 convolution (bf16 cuDNN of the same "
                     "convs is printed beside its time)",
}


def _detach(a):
    if isinstance(a, torch.Tensor):
        return a.detach()
    if isinstance(a, (list, tuple)):
        return type(a)(_detach(x) for x in a)
    return a


def _record(targets, run):
    """Call ``run()`` and return the (name, args) of every call of the
    functions ``targets`` (``(module, name)`` pairs) meanwhile, in order,
    args detached from any graph."""
    calls = []
    saved = {t: getattr(*t) for t in targets}

    def recorder(t):
        def rec(*args):
            calls.append((t[1], _detach(args)))
            return saved[t](*args)
        # shares the wrapped function's attributes: a wrapper that counts
        # its launches through its own module-level name keeps counting
        rec.__dict__ = saved[t].__dict__
        return rec

    for t in targets:
        setattr(*t, recorder(t))
    try:
        run()
    finally:
        for t in targets:
            setattr(*t, saved[t])
    torch.cuda.synchronize()
    return calls


def _timed_once(fn):
    """``fn()`` and its device ms, one call (no warm-up, no loop)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


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


def _q8_cost(inputs, group, outs):
    """Bytes and int8 operations of a W8A8 group's int8 launches: the int8
    input codes, int8 weights and fp32 epilogue vectors read once, the
    emitted blocks written once."""
    b = inputs[0].shape[0]
    ho, wo = outs[0].shape[2:]
    int8 = [j for j, r in enumerate(group.int8_read) if r]
    nbytes = sum(t.numel() for t in inputs)
    nbytes += sum(group.weights[j].numel() + 8 * group.specs[j].cout for j in int8)
    nbytes += sum(o.numel() * o.element_size() for o in outs)
    ops = sum(2 * group.weights[j].numel() * b * ho * wo for j in int8)
    return nbytes, ops


def _emit_all(group):
    """The same group returning every block (for block-by-block checks)."""
    return dataclasses.replace(group, specs=tuple(
        dataclasses.replace(s, emit=True) for s in group.specs))


def _library_conv(inputs, group, stripe_outs):
    """Per spec, F.conv2d over the materialized concat of its reads (the
    blocks taken from a plain run), summed: the cuDNN yardstick."""
    import torch.nn.functional as F

    from ocflow_torch.kernels.conv_chain import conv_group_plain

    blocks = list(inputs) + conv_group_plain(inputs, _emit_all(group))
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


def _bf16_conv_like_q8(inputs, group, blocks):
    """bf16 ``F.conv2d`` (cuDNN) of the same shapes as a W8A8 group's
    int8-read convs, on the codes as bf16: context for the int8 kernel's
    time (PyTorch has no int8 convolution)."""
    import torch.nn.functional as F

    blocks = list(inputs) + list(blocks)
    calls = []
    for j, s in enumerate(group.specs):
        if group.int8_read[j]:
            xcat = torch.cat([blocks[r] for r in s.reads], 1).bfloat16().contiguous()
            calls.append((xcat, group.weights[j].bfloat16(), s))

    def run():
        for xcat, w, s in calls:
            F.conv2d(xcat, w, None, stride=s.stride, padding=s.dilation,
                     dilation=s.dilation)

    return run


def _check_float(kind, args, dtype, max_err, label=""):
    """Replay one cost-volume (forward or backward) or bf16/fp32 conv-group
    call through the kernel and the plain version; hold them within
    KERNEL_TOL. A ``conv_group_diff`` call replays its forward: the conv
    group with every block emitted."""
    from ocflow_torch.kernels import conv_chain, cost_volume as cv_mod

    if kind == "cost_volume":
        got = [cv_mod.cost_volume(*args)]
        ref = [cv_mod.cost_volume_plain(*args)]
        shape = tuple(args[0].shape)
    elif kind == "cost_volume_bwd":
        got = cv_mod.cost_volume_backward(*args)
        ref = cv_mod.cost_volume_backward_plain(*args)
        shape = tuple(args[0].shape)
    elif kind == "conv_group_diff":
        inputs = args[0]
        group = _diff_group(*args)
        got = conv_chain.conv_group(inputs, group)
        ref = conv_chain.conv_group_plain(inputs, group)
        shape = tuple(inputs[0].shape)
    else:
        got = conv_chain.conv_group(*args)
        ref = conv_chain.conv_group_plain(*args)
        shape = tuple(args[0][0].shape)
    torch.cuda.synchronize()
    err = max((g.float() - r.float()).abs().max().item() for g, r in zip(got, ref))
    scale = max(r.float().abs().max().item() for r in ref)
    # gradients of a mean over millions of pixels are ~1e-6: no floor there
    tol = KERNEL_TOL[dtype] * max(scale, 1e-30 if kind == "cost_volume_bwd" else 1e-6)
    print(f"check {label}{kind} {str(dtype)[6:]} {shape}: max_abs_err "
          f"{err:.3e} rel {err / max(scale, 1e-30):.3e} max|plain| "
          f"{scale:.3e} tol {tol:.3e} ({TOL_REASON[dtype]})")
    if not err <= tol:
        raise AssertionError(f"{kind} {shape} {dtype}: {err} > {tol}")
    max_err[kind] = max(max_err[kind], err)


def _check_q8(args, max_err, label=""):
    """Replay one W8A8 group call, every block emitted, through the kernels
    and the plain version. int8-read convs: codes and bf16 values equal;
    the bf16-read conv (bf16 kernel): within 2^-6 of max|plain|. Returns
    the plain version's device ms (one call)."""
    from ocflow_torch.kernels import conv_chain_q8

    inputs, group = args
    every = _emit_all(group)
    got = conv_chain_q8.conv_group_q8(inputs, every)
    ref, plain_ms = _timed_once(lambda: conv_chain_q8.conv_group_q8_plain(inputs, every))
    shape = tuple(inputs[0].shape)
    ndiff = ncodes = 0
    err8 = err16 = 0.0
    for j, (g, r) in enumerate(zip(got, ref)):
        if g.dtype != r.dtype or g.shape != r.shape:
            raise AssertionError(f"q8 block {j}: {g.dtype} {g.shape} vs {r.dtype} {r.shape}")
        d = (g.float() - r.float()).abs()
        if group.int8_read[j]:
            ndiff += int((g != r).sum().item())
            ncodes += g.numel() if g.dtype == torch.int8 else 0
            err8 = max(err8, d.max().item())
        else:
            scale = r.float().abs().max().item()
            tol = KERNEL_TOL[torch.bfloat16] * max(scale, 1e-6)
            if not d.max().item() <= tol:
                raise AssertionError(f"q8 bf16-read block {j} {shape}: {d.max().item()} > {tol}")
            err16 = max(err16, d.max().item())
    print(f"check {label}conv_group_q8 {shape} ({len(group.specs)} convs, "
          f"{group.n_int8} int8): differing int8-read outputs {ndiff} "
          f"({ncodes} codes), int8-read max_abs_err {err8:.3e} (exact "
          f"required); bf16-read max_abs_err {err16:.3e} (2^-6 of max|plain|); "
          f"plain {plain_ms:.2f} ms")
    if ndiff:
        raise AssertionError(f"conv_group_q8 {shape}: {ndiff} outputs differ")
    max_err["conv_group_q8"] = max(max_err["conv_group_q8"], err8)
    max_err["conv_group"] = max(max_err["conv_group"], err16)
    return plain_ms


def _diff_group(inputs, weights, biases, specs):
    """The conv group a ``conv_group_diff`` call runs: every block emitted."""
    from ocflow_torch.kernels import conv_chain

    specs = [dataclasses.replace(s, emit=True) for s in specs]
    return conv_chain.prepare_group(weights, biases, specs, len(inputs),
                                    inputs[0].dtype, inputs[0].device)


def _eager_chain(inputs, weights, biases, specs):
    """The same chain as cuDNN convs over the materialized concat of each
    conv's reads: the library yardstick of ``conv_group_diff``."""
    import torch.nn.functional as F

    blocks, outs = list(inputs), []
    for s, w, b in zip(specs, weights, biases):
        y = F.conv2d(torch.cat([blocks[r] for r in s.reads], 1), w, b,
                     stride=s.stride, padding=s.dilation, dilation=s.dilation)
        y = F.leaky_relu(y, 0.1) if s.act else y
        blocks.append(y)
        outs.append(y)
    return outs


def _held_occlusion(run, mask=None):
    """``run()`` with the training step's range-map occlusion recorded
    (``mask`` None) or replaced by ``mask``; returns ``run()``'s result and
    the mask the step used."""
    from ocflow_torch.train import steps

    orig, box = steps.occlusion_from_back_flow, {}

    def occlusion(back_flow):
        box["mask"] = orig(back_flow) if mask is None else mask
        return box["mask"]

    steps.occlusion_from_back_flow = occlusion
    try:
        out = run()
    finally:
        steps.occlusion_from_back_flow = orig
    return out, box["mask"]


def _cv_bwd_cost(f1):
    """Bytes (g, f1, f2 read once; df1, df2 written once) and operations
    (a multiply and an add per shift, channel and pixel, for df1 and df2)
    of a cost-volume backward."""
    b, c, h, w = f1.shape
    nbytes = (81 * b * h * w + 4 * b * c * h * w) * f1.element_size()
    return nbytes, 4 * 81 * b * c * h * w


def _counters():
    from ocflow_torch.kernels import conv_chain, conv_chain_q8, cost_volume, gemm

    return {"cost_volume": cost_volume.cost_volume,
            "cost_volume_bwd": cost_volume.cost_volume_backward,
            "conv_group": conv_chain.conv_group,
            "conv_group_diff": conv_chain.conv_group_diff,
            "conv_group_q8": conv_chain_q8.conv_group_q8, "gemm_probe": gemm.gemm}


def _count_launches(run):
    """``run()`` with every launch counter zeroed just before; the counts
    just after, and ``run()``'s result."""
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    out = run()
    torch.cuda.synchronize()
    return {k: fn.launches for k, fn in counters.items()}, out


def _grad_errors(got, ref):
    """Per parameter: relative L2 and max-abs over max|ref|; and the
    relative L2 of the whole gradient."""
    rel_l2 = {n: ((got[n] - r).norm() / r.norm().clamp_min(1e-30)).item()
              for n, r in ref.items()}
    max_rel = {n: ((got[n] - r).abs().max() / r.abs().max().clamp_min(1e-30)).item()
               for n, r in ref.items()}
    num = sum(((got[n] - r) ** 2).sum().item() for n, r in ref.items())
    den = sum((r ** 2).sum().item() for r in ref.values())
    return rel_l2, max_rel, (num / den) ** 0.5


def _worst(d):
    k = max(d, key=d.get)
    return f"{d[k]:.3e} ({k})"


def _train_phase(card, max_err, per, add, failures):
    """The training slice at 448x1024, B=8 (longrun_synthetic.yaml hparams,
    a seeded FlowNetCV and smooth seeded frames, seed 0): kernel calls vs
    plain, the fused fp32 step vs the eager fp32 step, bf16 vs fp32, launch
    counts, five bf16 Adam steps, timings. Returns the launch counts of one
    bf16 step and of one with a W8A8 backward decode."""
    from ocflow_torch.bench import (BATCH, HEIGHT, SEED, WIDTH, calibration_batch,
                                    cuda_ms, make_train_inputs, measure_train,
                                    train_hparams)
    from ocflow_torch.kernels import conv_chain, cost_volume as cv_mod
    from ocflow_torch.models import pwc_fast
    from ocflow_torch.models.pwc_net import DECODER_LEVELS, GROWTH
    from ocflow_torch.tools import train_profile
    from ocflow_torch.train import create_train_state, make_unsupervised_flow_step

    dev = torch.device("cuda")
    hp_b = train_hparams()
    hp_f = {**hp_b, "compute_dtype": "float32"}
    state0, _, batch = make_train_inputs(BATCH, HEIGHT, WIDTH, dev, SEED, hp_b)
    model0, lr = state0.model, hp_b["learning_rate"]
    targets = [(pwc_fast, "cost_volume"), (pwc_fast, "conv_group"),
               (pwc_fast, "conv_group_diff"), (cv_mod, "cost_volume_backward")]
    names = {"cost_volume_backward": "cost_volume_bwd"}

    def one_step(hp, record=False, mask=None):
        """One Adam step on a copy of the seed model: metrics, gradients,
        parameters after the step, (``record``) the kernel calls, and the
        step's range-map occlusion mask (``mask``: held at that mask)."""
        m = copy.deepcopy(model0)
        state = create_train_state(m, lr, device=dev)
        step, _ = make_unsupervised_flow_step(hp)
        box = {}

        def run():
            box["metrics"] = step(state, batch)[1]

        calls, occ = _held_occlusion(
            lambda: _record(targets, run) if record else run(), mask)
        torch.cuda.synchronize()
        grads = {n: p.grad.detach().float().clone() for n, p in m.named_parameters()}
        params = {n: p.detach().clone() for n, p in m.named_parameters()}
        metrics = {k: float(v) for k, v in box["metrics"].items()}
        return metrics, grads, params, calls, occ

    # 1. every kernel call of one fp32 step (pair + loss + backward) and of
    # one bf16 step, kernel vs plain
    torch.cuda.reset_peak_memory_stats()
    m32, g32, p32, calls32, occ32 = one_step(hp_f, record=True)
    for kind, args in calls32:
        _check_float(names.get(kind, kind), args, torch.float32, max_err, "train ")
    mb, gb, _, calls_b, _ = one_step(hp_b, record=True)
    for kind, args in calls_b:
        _check_float(names.get(kind, kind), args, torch.bfloat16, max_err, "train ")
    del calls32
    print(f"train: peak device memory over the fp32 and bf16 steps "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # 2. fused fp32 step vs eager fp32 step (TF32 off), beside what the gap
    # is made of: each step's run-to-run spread (atomic adds), the eager
    # step against itself with cuDNN's deterministic algorithms (summation
    # order alone), and fused vs eager with the fused run's occlusion mask
    # held (the mask's share of the gap)
    eager = {**hp_f, "fast_forward": "off"}
    me, ge, pe, _, occ_e = one_step(eager)
    docc = (occ_e - occ32).abs()
    gaps = {"fused run to run": (g32, one_step(hp_f)[1]),
            "eager run to run": (ge, one_step(eager)[1])}
    torch.backends.cudnn.deterministic = True
    try:
        gaps["eager vs eager, deterministic cuDNN"] = (ge, one_step(eager)[1])
    finally:
        torch.backends.cudnn.deterministic = False
    gaps["fused vs eager, mask held"] = (g32, one_step(eager, mask=occ32)[1])
    gaps["fused vs eager"] = (g32, ge)
    errs = {what: _grad_errors(a, b) for what, (a, b) in gaps.items()}
    del gaps
    for what, (rel_l2, max_rel, glob) in errs.items():
        print(f"train fp32 grads, {what}: rel_l2 {_worst(rel_l2)}, max-abs/max "
              f"{_worst(max_rel)}, global rel_l2 {glob:.3e}")
    rel_l2, max_rel, glob = errs["fused vs eager"]
    print(f"train fp32 occlusion mask (soft, in [0, 1]), fused vs eager: max-abs "
          f"{docc.max().item():.3e}, mean-abs {docc.mean().item():.3e}")
    metric_rel = {k: abs(m32[k] - me[k]) / max(abs(me[k]), 1e-30) for k in me}
    init = dict(model0.named_parameters())
    dp = max((p32[n] - pe[n]).abs().max().item() for n in pe)
    moved = min((p32[n] - init[n]).abs().max().item() for n in p32)
    n_flip = sum(int(((p32[n] - pe[n]).abs() > lr).sum().item()) for n in pe)
    print(f"train fp32 fused vs eager: metrics {m32} vs {me}; max rel "
          f"{_worst(metric_rel)} (tol {TRAIN_METRIC_REL}); grad rel_l2 "
          f"{_worst(rel_l2)} (tol {TRAIN_GRAD_REL_L2}), max-abs/max "
          f"{_worst(max_rel)} (tol {TRAIN_GRAD_MAX_REL}), global rel_l2 "
          f"{glob:.3e} (tol {TRAIN_GRAD_GLOBAL}); params after Adam max-abs {dp:.3e} "
          f"(sanity tol {TRAIN_PARAM_ATOL}; {n_flip} weights' updates differ by more "
          f"than lr; every tensor moved by >= {moved:.3e})")
    if set(m32) != set(me) or max(metric_rel.values()) > TRAIN_METRIC_REL:
        failures.append(f"train fused vs eager metrics {metric_rel}")
    if (max(rel_l2.values()) > TRAIN_GRAD_REL_L2 or glob > TRAIN_GRAD_GLOBAL
            or max(max_rel.values()) > TRAIN_GRAD_MAX_REL):
        failures.append(f"train fused vs eager grads {_worst(rel_l2)} "
                        f"{_worst(max_rel)} {glob}")
    if dp > TRAIN_PARAM_ATOL or not moved > 0:
        failures.append(f"train params after Adam {dp} (moved {moved})")
    for k, v in {**m32, **mb}.items():
        if v != v or abs(v) == float("inf"):
            failures.append(f"train metric {k} not finite")
    del ge, pe, p32, occ32, occ_e, docc

    # 3. bf16 step vs fp32 step
    rel_l2, max_rel, glob = _grad_errors(gb, g32)
    print(f"train bf16 vs fp32: loss {mb['loss']:.6f} vs {m32['loss']:.6f}; grad "
          f"global rel_l2 {glob:.4f} (tol {TRAIN_BF16_REL_L2}), per tensor rel_l2 "
          f"{_worst(rel_l2)}, median {sorted(rel_l2.values())[len(rel_l2) // 2]:.4f}")
    if not glob <= TRAIN_BF16_REL_L2:
        failures.append(f"train bf16 vs fp32 grad rel_l2 {glob}")
    del gb, g32

    # 4. launches of one bf16 step, and of one with a W8A8 backward decode
    scales = pwc_fast.calibrate_q8(copy.deepcopy(model0).bfloat16(),
                                   calibration_batch(batch["images"].bfloat16()))
    n_diff = (len(DECODER_LEVELS) - 1) * (len(GROWTH) + 1) + len(GROWTH) + 2
    launches = {}
    for path, q8 in (("train", None), ("train_q8", scales)):
        state = create_train_state(copy.deepcopy(model0), lr, device=dev)
        step, _ = make_unsupervised_flow_step({**hp_b, "q8_backward": q8})
        step(state, batch)  # packs the weights
        # the pair runs the serving decode only: no encoder groups
        fw = pwc_fast.prepare(state.model, torch.bfloat16, dev, q8)
        n_enc = sum(len(g.specs) for g in fw.encoder)
        launches[path], _ = _count_launches(lambda: step(state, batch))
        expect = {"cost_volume": 10, "cost_volume_bwd": 5,
                  "conv_group": n_diff + fw.launch_counts()["conv_group"] - n_enc,
                  "conv_group_diff": n_diff,
                  "conv_group_q8": fw.launch_counts()["conv_group_q8"], "gemm_probe": 0}
        print(f"main path {path} (one bf16 step) launches: {launches[path]} "
              f"(expected {expect})")
        if launches[path] != expect:
            raise AssertionError(f"{path} launch counts {launches[path]}")
        del state

    # 5. five bf16 Adam steps
    state = create_train_state(copy.deepcopy(model0), lr, device=dev)
    step, _ = make_unsupervised_flow_step(hp_b)
    start = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    losses = [float(step(state, batch)[1]["loss"]) for _ in range(5)]
    moved = min((p.detach() - start[n]).abs().max().item()
                for n, p in state.model.named_parameters())
    print(f"train bf16 5 Adam steps: loss {losses}; every tensor moved by >= {moved:.3e}")
    if not all(v == v and abs(v) != float("inf") for v in losses) or not moved > 0:
        failures.append(f"train bf16 steps: loss {losses}, moved {moved}")
    del state, start

    # 6. timing: the bf16 step end to end, then its new kernels' calls
    state, step, _ = make_train_inputs(BATCH, HEIGHT, WIDTH, dev, SEED, hp_b)
    res = measure_train(state, step, batch)
    print(f"e2e train step bf16 B={BATCH} {HEIGHT}x{WIDTH}: {res['ms_per_step']:.3f} "
          f"ms/step, {res['pairs_per_sec']:.2f} pairs/s [{card}]")
    del state, step

    # where the bf16 step's time goes: CUDA events at the step's marks
    runs = 5
    parts = train_profile.step_parts(runs)[0]
    total = sum(parts.values())
    print(f"train step bf16 breakdown (device ms between the step's marks, mean of "
          f"{runs}; {total:.3f} ms in all): " + ", ".join(
              f"{k} {v:.3f} ({100 * v / total:.1f}%)" for k, v in parts.items())
          + f" [{card}]")

    for kind, args in calls_b:
        if kind == "cost_volume_backward":
            k_ms = cuda_ms(lambda: cv_mod.cost_volume_backward(*args), 20)
            p_ms = cuda_ms(lambda: cv_mod.cost_volume_backward_plain(*args), 3)
            nbytes, ops = _cv_bwd_cost(args[0])
            bound, by = add("cost_volume_bwd", k_ms, p_ms, nbytes, ops,
                            PEAK_FLOPS[torch.bfloat16], None)
            print(f"time cost_volume_bwd bf16 {tuple(args[0].shape)}: kernel {k_ms:.4f} ms, "
                  f"plain {p_ms:.4f} ms, library none, bound {bound:.4f} ms ({by}; "
                  f"{nbytes} B, {ops} flop) [{card}]")
        elif kind == "conv_group_diff":
            inputs, weights, biases, specs = args
            group = _diff_group(*args)
            with torch.no_grad():
                outs = conv_chain.conv_group(inputs, group)
                k_ms = cuda_ms(lambda: conv_chain.conv_group_diff(*args), 5)
                p_ms = cuda_ms(lambda: conv_chain.conv_group_plain(inputs, group), 3)
                lib_ms = cuda_ms(lambda: _eager_chain(*args), 5)
            gouts = [torch.randn_like(o) for o in outs]
            leaves = [t.clone().requires_grad_() for t in (*inputs, *weights, *biases)]
            n_in, n = len(inputs), len(specs)
            split = (leaves[:n_in], leaves[n_in:n_in + n], leaves[n_in + n:])
            acts = conv_chain.conv_group_diff(*split, specs)
            bwd_ms = cuda_ms(lambda: torch.autograd.grad(acts, leaves, gouts,
                                                         retain_graph=True), 3)
            ref = _eager_chain(*split, specs)
            lib_bwd_ms = cuda_ms(lambda: torch.autograd.grad(ref, leaves, gouts,
                                                             retain_graph=True), 3)
            del acts, ref, leaves, gouts
            nbytes, flops = _cg_cost(inputs, group, outs)
            bound, by = add("conv_group_diff", k_ms, p_ms, nbytes, flops,
                            PEAK_FLOPS[torch.bfloat16], lib_ms)
            per["conv_group_diff"]["bwd_ms"] += bwd_ms
            per["conv_group_diff"]["library_bwd_ms"] += lib_bwd_ms
            print(f"time conv_group_diff bf16 {tuple(inputs[0].shape)} ({n} convs): "
                  f"forward kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, library "
                  f"(cuDNN over the concat) {lib_ms:.4f} ms, bound {bound:.4f} ms ({by}; "
                  f"{nbytes} B, {flops} flop); backward (cuDNN conv VJPs) {bwd_ms:.4f} ms, "
                  f"library autograd {lib_bwd_ms:.4f} ms [{card}]")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from ocflow_torch.bench import (BATCH, HEIGHT, SEED, WIDTH, calibration_batch,
                                    cuda_ms, gpu_info, make_inputs, measure)
    from ocflow_torch.kernels import _build, conv_chain, conv_chain_q8
    from ocflow_torch.kernels import cost_volume as cv_mod
    from ocflow_torch.models import pwc_fast
    from ocflow_torch.tools import spike_int8
    from ocflow_torch.tools.q8_error import flow_errors

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = gpu_info()
    print(card)  # name, power limit: the line nvidia-smi gives
    dev = torch.device("cuda")

    # 2. build
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s wall; " + ", ".join(
        f"{k} {v['seconds']:.2f} s" for k, v in built.items()))

    model, x32 = make_inputs(BATCH, HEIGHT, WIDTH, torch.float32, "cuda", SEED)
    model.eval()
    model_b = copy.deepcopy(model).bfloat16()
    xb = x32.bfloat16()
    max_err = {"cost_volume": 0.0, "conv_group": 0.0, "conv_group_q8": 0.0,
               "cost_volume_bwd": 0.0, "conv_group_diff": 0.0}
    serving = [(pwc_fast, n) for n in ("cost_volume", "conv_group", "conv_group_q8")]

    # 3. every kernel call of the bf16/fp32 path, kernel vs plain
    recorded = {}
    for dtype, m, x in ((torch.float32, model, x32), (torch.bfloat16, model_b, xb)):
        calls = _record(serving, lambda: pwc_fast.fast_apply(m, x))
        recorded[dtype] = calls
        for kind, args in calls:
            _check_float(kind, args, dtype, max_err)

    # 4. W8A8: calibrate on the held-out batch, replay every call
    t0 = time.perf_counter()
    xc = calibration_batch(xb)
    scales = {"w8a8": pwc_fast.calibrate_q8(model_b, xc),
              "w8a8_enc_ctx": pwc_fast.calibrate_q8(model_b, xc, encoder=True, ctx=True)}
    del xc
    print(f"calibrate_q8 (bf16, seed-1 batch, decoders; then + encoder and "
          f"context chain): {time.perf_counter() - t0:.2f} s host")
    q8_plain_ms = []
    for mode, sc in scales.items():
        label = f"{mode} "
        calls = _record(serving, lambda: pwc_fast.fast_apply(model_b, xb, q8=sc))
        if mode == "w8a8":
            recorded[mode] = calls
        for kind, args in calls:
            if kind == "conv_group_q8":
                ms = _check_q8(args, max_err, label)
                if mode == "w8a8":
                    q8_plain_ms.append(ms)
            else:
                _check_float(kind, args, torch.bfloat16, max_err, label)
        del calls

    # 5. each path once, its launches counted
    want = {"bf16": pwc_fast.prepare(model_b, torch.bfloat16, dev).launch_counts(),
            "w8a8": pwc_fast.prepare(model_b, torch.bfloat16, dev,
                                     scales["w8a8"]).launch_counts()}
    launches, outs = {}, {}
    launches["bf16"], outs["bf16"] = _count_launches(
        lambda: pwc_fast.fast_apply(model_b, xb))
    launches["w8a8"], outs["w8a8"] = _count_launches(
        lambda: pwc_fast.fast_apply(model_b, xb, q8=scales["w8a8"]))
    launches["spike_int8"], gemm_res = _count_launches(
        spike_int8.probe)
    for path in ("bf16", "w8a8"):
        expect = {"cost_volume": 5, "cost_volume_bwd": 0, "conv_group_diff": 0,
                  **want[path], "gemm_probe": 0}
        print(f"main path {path} launches: {launches[path]} (expected {expect})")
        if launches[path] != expect:
            raise AssertionError(f"{path} launch counts {launches[path]}")
    if (launches["w8a8"]["conv_group"], launches["w8a8"]["conv_group_q8"]) != (24, 35):
        raise AssertionError(f"W8A8 launches {launches['w8a8']}, want 24 / 35")
    print(f"main path spike_int8 launches: {launches['spike_int8']}")
    if launches["spike_int8"]["gemm_probe"] < 2:
        raise AssertionError("the GEMM probe did not launch its kernel")
    for name, r in gemm_res.items():
        print(f"check gemm_probe {name} {spike_int8.SIZE}^3: max_abs_err "
              f"{r['max_abs_err']:.3e} ({'exact required' if name == 'int8' else '1e-2 of max|plain|'})")

    # 6. end to end
    out_f = pwc_fast.fast_apply(model, x32)
    with torch.no_grad():
        ref = model(x32)
    outs["w8a8_enc_ctx"] = pwc_fast.fast_apply(model_b, xb, q8=scales["w8a8_enc_ctx"])
    torch.cuda.synchronize()
    failures = []
    for i, name in enumerate(("full", "quarter")):
        want_shape = (BATCH, HEIGHT, WIDTH, 2) if name == "full" else (
            BATCH, HEIGHT // 4, WIDTH // 4, 2)
        r = ref[i]
        for t in (out_f[i], *(o[i] for o in outs.values())):
            if tuple(t.shape) != want_shape or t.dtype != torch.float32 \
                    or not torch.isfinite(t).all():
                raise AssertionError(f"{name}: bad output {t.shape} {t.dtype}")
        scale = r.abs().max().item()
        err32 = (out_f[i] - r).abs().max().item()
        eb = flow_errors(outs["bf16"][i], r)
        print(f"e2e {name}: fp32 fast vs eager max_abs_err {err32:.3e} "
              f"(tol {E2E_FP32_TOL * scale:.3e}, max|eager| {scale:.3e}); "
              f"bf16 vs fp32 rel_l2 {eb['rel_l2']:.4f} (tol {E2E_BF16_REL_L2}) "
              f"max_abs_err {eb['max_abs']:.3e}")
        if not err32 <= E2E_FP32_TOL * scale:
            failures.append(f"{name}: fp32 fast_apply vs eager {err32}")
        if not eb["rel_l2"] <= E2E_BF16_REL_L2:
            failures.append(f"{name}: bf16 vs fp32 rel_l2 {eb['rel_l2']}")
        for mode, tol in E2E_Q8_TOL.items():
            e = flow_errors(outs[mode][i], r)
            e16 = flow_errors(outs[mode][i], outs["bf16"][i])
            print(f"e2e {name}: {mode} vs fp32 eager rel_l2 {e['rel_l2']:.4f} "
                  f"max_abs_err {e['max_abs']:.3e} ({e['max_abs_rel']:.4f} of "
                  f"max|eager|; quarter tol {tol}); vs bf16 fast_apply rel_l2 "
                  f"{e16['rel_l2']:.4f} max_abs_err {e16['max_abs']:.3e}")
            if name == "quarter" and not e["max_abs_rel"] <= tol:
                failures.append(f"{mode} vs fp32 eager: {e['max_abs_rel']} of max > {tol}")
    if failures:
        raise AssertionError("; ".join(failures))

    # 7. timing (bf16 serving shapes), beside the card on the line above
    per = {k: {"ms": 0.0, "plain_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
               "bound_ms": 0.0, "library_ms": 0.0}
           for k in ("cost_volume", "cost_volume_bwd", "conv_group",
                     "conv_group_diff", "conv_group_q8")}
    per["conv_group_diff"].update(bwd_ms=0.0, library_bwd_ms=0.0)

    def add(kind, k_ms, p_ms, nbytes, ops, peak, lib_ms):
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        o_ms = ops / peak * 1e3
        p = per[kind]
        p["ms"] += k_ms
        p["plain_ms"] += p_ms
        p["bytes_ms"] += b_ms
        p["ops_ms"] += o_ms
        p["bound_ms"] += max(b_ms, o_ms)
        p["library_ms"] += lib_ms or 0.0
        return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations"

    for kind, args in recorded[torch.bfloat16]:
        if kind == "cost_volume":
            k_ms = cuda_ms(lambda: cv_mod.cost_volume(*args), 20)
            p_ms = cuda_ms(lambda: cv_mod.cost_volume_plain(*args), 3)
            nbytes, flops = _cv_cost(args[0])
            lib_ms = None
            shape = tuple(args[0].shape)
        else:
            outs_cg = conv_chain.conv_group(*args)
            k_ms = cuda_ms(lambda: conv_chain.conv_group(*args), 5)
            p_ms = cuda_ms(lambda: conv_chain.conv_group_plain(*args), 3)
            lib_ms = cuda_ms(_library_conv(*args, outs_cg), 5)
            nbytes, flops = _cg_cost(*args, outs_cg)
            shape = tuple(args[0][0].shape)
        bound, by = add(kind, k_ms, p_ms, nbytes, flops, PEAK_FLOPS[torch.bfloat16], lib_ms)
        print(f"time {kind} bf16 {shape}: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, library {lib_ms if lib_ms is None else round(lib_ms, 4)} ms, "
              f"bound {bound:.4f} ms ({by}; {nbytes} B, {flops} flop) [{card}]")

    # the int8 launches of each W8A8 group (its bf16-read up-flow conv runs
    # the bf16 kernel and is left out here)
    q8_calls = [args for kind, args in recorded["w8a8"] if kind == "conv_group_q8"]
    skip_bf16 = conv_chain_q8.launch_conv
    for args, p_ms in zip(q8_calls, q8_plain_ms, strict=True):
        inputs, group = args
        outs_q8 = conv_chain_q8.conv_group_q8(*args)
        conv_chain_q8.launch_conv = lambda *a, **k: None
        try:
            k_ms = cuda_ms(lambda: conv_chain_q8.conv_group_q8(*args), 5)
        finally:
            conv_chain_q8.launch_conv = skip_bf16
        blocks = conv_chain_q8.conv_group_q8(inputs, _emit_all(group))
        yard_ms = cuda_ms(_bf16_conv_like_q8(inputs, group, blocks), 5)
        nbytes, ops = _q8_cost(inputs, group, outs_q8)
        bound, by = add("conv_group_q8", k_ms, p_ms, nbytes, ops,
                        PEAK_FLOPS[torch.int8], None)
        shape = tuple(inputs[0].shape)
        print(f"time conv_group_q8 w8a8 {shape} ({group.n_int8} int8 convs): kernel "
              f"{k_ms:.4f} ms ({ops / k_ms / 1e9:.1f} TOP/s), plain {p_ms:.4f} ms, "
              f"library none (bf16 cuDNN conv of the same shapes {yard_ms:.4f} ms), "
              f"bound {bound:.4f} ms ({by}; {nbytes} B, {ops} op) [{card}]")
    for name, r in gemm_res.items():
        print(f"time gemm_probe {name} {spike_int8.SIZE}^3: kernel {r['ms']:.4f} ms "
              f"({r['tops']:.1f} TOP/s), library {r['library_ms']:.4f} ms "
              f"({r['library_tops']:.1f} TOP/s), plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) [{card}]")

    # end to end in turns: bf16, W8A8, W8A8, bf16
    e2e = {"bf16": [], "w8a8": []}
    for path in ("bf16", "w8a8", "w8a8", "bf16"):
        e2e[path].append(measure(model_b, xb, scales["w8a8"] if path == "w8a8" else None))
    for path, runs in e2e.items():
        each = [r["ms_per_batch"] for r in runs]
        ms = sum(each) / len(each)
        print(f"e2e {path} fast_apply B={BATCH} {HEIGHT}x{WIDTH}: {ms:.3f} ms/batch, "
              f"{BATCH * 1e3 / ms:.2f} pairs/s (runs {each} ms) [{card}]")

    # 8. training (the serving records freed first)
    del recorded, outs, out_f, ref, model, model_b, x32, xb
    torch.cuda.empty_cache()
    failures = []
    launches.update(_train_phase(card, max_err, per, add, failures))
    if failures:
        raise AssertionError("; ".join(failures))

    # per kernel: its source, the TPU kernel it replaces, and the path whose
    # calls its times sum (its "launches" are that path's count)
    meta = {
        "cost_volume": ("ocflow_torch/csrc/cost_volume.cu",
                        "ocflow_tpu/ops/pallas/cost_volume_kernel.py:91", "bf16"),
        "cost_volume_bwd": ("ocflow_torch/csrc/cost_volume_bwd.cu",
                            "ocflow_tpu/ops/pallas/cost_volume_kernel.py:187", "train"),
        "conv_group": ("ocflow_torch/csrc/conv_group.cu",
                       "ocflow_tpu/ops/pallas/conv_chain_kernel.py:463", "bf16"),
        "conv_group_diff": ("ocflow_torch/csrc/conv_group.cu",
                            "ocflow_tpu/ops/pallas/conv_chain_kernel.py:1198", "train"),
        "conv_group_q8": ("ocflow_torch/csrc/conv_group_q8.cu",
                          "ocflow_tpu/ops/pallas/conv_chain_kernel.py:943", "w8a8"),
        "gemm_probe": ("ocflow_torch/csrc/gemm_probe.cu", "tools/spike_int8.py:92",
                       "spike_int8"),
    }
    for p in per.values():
        p["bound_by"] = "bytes" if p["bytes_ms"] >= p["ops_ms"] else "operations"
    per["gemm_probe"] = gemm_res["int8"]
    max_err["gemm_probe"] = gemm_res["int8"]["max_abs_err"]
    kernels = []
    for name, (source, replaces, path) in meta.items():
        p = per[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "path": path, "launches": launches[path][name],
            "launches_by_path": {k: c[name] for k, c in launches.items()},
            "max_abs_err": max_err[name], "ms": p["ms"],
            "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"],
            "bound_by": p["bound_by"],
            "library_ms": p["library_ms"] if name in (
                "conv_group", "conv_group_diff", "gemm_probe") else None,
            **({"library_reason": NO_LIBRARY[name]} if name in NO_LIBRARY else {}),
            **{k: p[k] for k in ("bwd_ms", "library_bwd_ms") if k in p},
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
