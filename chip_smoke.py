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
   per conv, 59, of which 53 on the staged kernel: all but the six stride-2
   encoder convs), the W8A8 forward (5, 24 bf16 of which 18 staged, 35
   int8 launches, all 35 on the staged int8 kernel), the opt-in W8A8
   forward (as ``launch_counts()`` reckons: its six stride-2 encoder convs
   and four dilated context convs on the int8 gather kernel) and the GEMM
   probe ``ocflow_torch.tools.spike_int8`` (2048^3, int8 exact, bf16 within
   1e-2);
6. hold fp32 ``fast_apply`` against the eager fp32 ``FlowNetCV`` (cuDNN,
   TF32 off), also with PyTorch's default TF32 flags, bf16 against fp32,
   W8A8 against the eager fp32 forward;
7. time every kernel at the path's shapes against its plain version, its
   bound and a library yardstick (conv groups with their TFLOP/s or TOP/s
   and share of the bound), and the bf16 and W8A8 forwards end to end
   (pairs/s) in turns;
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
   ``conv_group_diff`` conv launches, 72 conv launches in all, every one
   staged) and of one with a W8A8 backward decode (37 staged, 35 int8, all
   on the staged int8 kernel);
   five bf16 Adam steps;
   the bf16 step end to end, and the new kernels' calls against plain,
   bound and cuDNN;
9. FlowNetC family serving (FlowNetC, OcclusionNetC, FlowOccNetC, seeded
   with BatchNorm statistics, B=8, 448x1024, fp32, eval mode): per net, the
   launches of one forward (one d=10 cost volume, no other kernel), the
   d=10 call replayed against its plain version in fp32 and cast to bf16,
   the forward against the same forward on the plain cost volume (also
   with PyTorch's default TF32 flags), the d=10 call's time against its
   plain version and bound, the forward end to end; FlowNetC's fp32 input
   gradient under a seeded cotangent (one d=10 forward and one d=10
   backward launch) against the gradient with the plain backward on the
   same forward (cuDNN's deterministic algorithms in both), its d=10
   backward call replayed against its plain version in fp32 and cast to
   bf16, and timed beside its bound;
10. the training system on ``configs/longrun_synthetic.yaml`` at full width
   (448x1024, B=8), cut to 44 samples (35 / 4 / 5), 2 epochs, every step
   logged and panels every epoch, outputs in a temporary directory:
   ``SyntheticFlowWarp`` generated on the card against the same samples on
   the CPU (1e-4) and its ms per sample; the device cache's bytes and
   dtypes; ``make_loaders`` + ``fit`` with the launches of one train step
   counted (10 cost volumes, 5 backward, 72 conv launches of which 31
   ``conv_group_diff``, all staged, no int8) and of one eval step; the
   CSV's rows and finite losses; the PNG panels decoded with zlib and
   equal to the panels; the best checkpoint restored into a fresh model
   and Adam, bit for bit, and ``evaluate`` on it against the in-memory
   state (1e-6 relative); the loop's ms per step (CUDA events) beside
   ``bench.measure_train``'s on a batch of the loader.

11. the file-backed data path and both CLIs at real sizes, from the seed,
   in a temporary directory: a Sintel tree (2 scenes of 5 frames, 436x1024,
   ``.flo`` flows, 0/255 occlusion PNGs), a KITTI 2015 tree (3 pairs,
   375x1242, sparse 16-bit flow PNGs) and a FlyingChairs2 tree (24 pairs,
   384x512), every PNG written by the port's writer with a seeded mix of
   the five row filters; frames, masks, ``.flo`` and 16-bit flows read back
   bit for bit; the host decode's ms per pair (one thread, the loader's 6);
   ``python -m ocflow_torch.evaluate --task flow --model pwc`` on
   ``MpiSintelClean`` (384x1024, B=8) and ``KITTI2015`` (320x1216: level 6
   is 19 wide) and ``--task flow_occ --model flowoccnetc`` on
   ``MpiSintelFlowOccClean``: each batch's launches (5 cost volumes, or 1
   at d=10), every cost-volume call replayed against its plain version
   (fp32, 1e-4 of max|plain|), the EPE and F1 against the same evaluation
   on the plain cost volume (1e-4 relative); ``evaluate``'s steady pairs/s
   over 12 batches of 8 (a 96-pair tree of links to the Sintel frames),
   timed from the second batch on, beside the decode and the warm forward,
   and the card's busy share there from a ``torch.profiler`` trace;
   ``python -m ocflow_torch.infer --q8 --save_flo`` on 16 pairs of Sintel
   frames (links, as above) and on the KITTI frames, pair by pair: each
   ``.flo`` equal to ``fast_apply``'s flow bit for bit, launches per pair
   5 / 0 / 24 / 0 / 35, every kernel call of the first pair replayed
   against its plain version, the W8A8 quarter flow against the eager fp32
   forward (0.1 of max|flow_quarter|), pairs/s after the first pair; one epoch of ``fit`` on the
   FlyingChairs2 tree through ``make_loaders`` with ``root`` and the device
   cache, the first train step's kernel calls replayed (bf16), the second's
   launches (10 / 5 / 72 / 31 / 0), the test metrics finite.

Phases 6 and 8 hold their references (the eager fp32 forward, the eager
step) on the plain cost volume; phase 6 also holds the eager forward on the
cost-volume kernel (5 launches) against it.

Prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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
# phase 9: FlowNetC's fp32 gradient with respect to its input (TF32 off),
# through the d=10 kernels, vs the same gradient with the plain backward in
# place of the backward kernel on the same forward, both with cuDNN's
# deterministic algorithms, max-abs over max|grad|: the two differ in the
# cost-volume backward's summation order only, carried back through
# conv3..conv1's VJPs, as the forward's 1e-4 (2.3e-7-2.9e-7 measured on
# the H100). The gradient moves further when anything else changes: with
# cuDNN's default algorithms it read 3.2e-4 from the reference, with the
# plain cost volume's forward 9.2e-4 (the forward's summation order flips
# a few LeakyReLU slopes), which is why the check holds the forward and
# cuDNN's algorithms fixed; both readings are printed beside it.
GRAD_FP32_TOL = 1e-4
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

# phase 10: the fit loop's cuts of configs/longrun_synthetic.yaml (full
# width: 448x1024, B=8): 44 samples split 35 / 4 / 5, so 4 train steps per
# epoch, a ragged val batch of 4 and a ragged test batch of 5
FIT_CUTS = {"dataset_size": 44, "max_epochs": 2, "log_every_n_steps": 1,
            "log_image_every_epoch": 1}
# cuda samples vs the same samples generated on the CPU by the port: the
# blur's and the remap's summation order (the port vs OpenCV on the CPU
# reads <= 1e-5)
FIT_DATA_TOL = {"images": 1e-4, "flow": 1e-4}
# a train step's launches (PERF.md §3): cost volume 10, its backward 5, 72
# bf16 conv launches all staged (31 conv_group_diff + 41 of the backward
# decode), no int8
FIT_STEP_LAUNCHES = {"cost_volume": 10, "cost_volume_bwd": 5, "conv_group": 72,
                     "conv_group_diff": 31, "conv_group_q8": 0, "gemm_probe": 0,
                     "conv_group_staged": 72, "conv_group_q8_staged": 0}
# evaluate on the restored state vs the in-memory state, per metric,
# relative: the same weights; the range map's index_add_ adds with atomics
FIT_EVAL_REL = 1e-6


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


def _cv_cost(f1, d=4):
    """Bytes (f1, f2 read once, the (2d+1)^2 maps written once) and
    operations (a multiply and an add per shift, channel and pixel) of a
    cost-volume forward."""
    b, c, h, w = f1.shape
    k = (2 * d + 1) ** 2
    nbytes = (2 * b * c * h * w + k * b * h * w) * f1.element_size()
    return nbytes, 2 * k * b * c * h * w


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


def _cv_bwd_cost(f1, d=4):
    """Bytes (g, f1, f2 read once; df1, df2 written once) and operations
    (a multiply and an add per shift, channel and pixel, for df1 and df2)
    of a cost-volume backward with (2d+1)^2 shifts."""
    b, c, h, w = f1.shape
    k = (2 * d + 1) ** 2
    nbytes = (k * b * h * w + 4 * b * c * h * w) * f1.element_size()
    return nbytes, 4 * k * b * c * h * w


class _PlainBackward(torch.autograd.Function):
    """A cost volume whose forward is ``forward_fn`` and whose backward is
    the plain version: the references of phase 9's input gradient."""

    @staticmethod
    def forward(ctx, f1, f2, d, forward_fn):
        ctx.save_for_backward(f1, f2)
        ctx.d = d
        return forward_fn(f1, f2, d)

    @staticmethod
    def backward(ctx, g):
        from ocflow_torch.kernels.cost_volume import cost_volume_backward_plain

        df1, df2 = cost_volume_backward_plain(*ctx.saved_tensors, g.contiguous(), ctx.d)
        return df1, df2, None, None


@contextlib.contextmanager
def _plain_eager_cost_volume(active: bool = True):
    """The eager FlowNetCV on the plain cost volume while inside (a
    reference that does not run the kernel it is held against)."""
    from ocflow_torch.kernels.cost_volume import cost_volume_plain
    from ocflow_torch.models import pwc_net

    saved = pwc_net.cost_volume
    if active:
        pwc_net.cost_volume = cost_volume_plain
    try:
        yield
    finally:
        pwc_net.cost_volume = saved


def _no_grad(model, x):
    with torch.no_grad():
        return model(x)


def _counters():
    from ocflow_torch.kernels import conv_chain, conv_chain_q8, cost_volume, gemm

    return {"cost_volume": cost_volume.cost_volume,
            "cost_volume_bwd": cost_volume.cost_volume_backward,
            "conv_group": conv_chain.conv_group,
            "conv_group_diff": conv_chain.conv_group_diff,
            "conv_group_q8": conv_chain_q8.conv_group_q8, "gemm_probe": gemm.gemm}


STAGED = ("conv_group", "conv_group_q8")  # wrappers that count staged launches too


def _zero_counts():
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    for k in STAGED:
        counters[k].staged_launches = 0


def _read_counts():
    """Every launch counter now, with ``conv_group_staged`` and
    ``conv_group_q8_staged`` (the conv launches on the staged bf16 and int8
    kernels)."""
    counters = _counters()
    counts = {k: fn.launches for k, fn in counters.items()}
    counts.update({f"{k}_staged": counters[k].staged_launches for k in STAGED})
    return counts


def _count_launches(run):
    """``run()`` with every launch counter zeroed just before; the counts
    just after, and ``run()``'s result."""
    _zero_counts()
    out = run()
    torch.cuda.synchronize()
    return _read_counts(), out


def _rate(flops, ms, bound_ms):
    """Achieved TFLOP/s and share of the bound of one timed call."""
    return f"{flops / ms / 1e9:.1f} TFLOP/s, {100 * bound_ms / ms:.2f}% of bound"


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
            # the eager step (the fused step's reference) on the plain cost
            # volume, as before the eager FlowNetCV took the kernel
            with _plain_eager_cost_volume(hp.get("fast_forward") == "off"):
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
        n_enc_staged = sum(conv_chain.is_staged(g.dtype, s)
                           for g in fw.encoder for s in g.specs)
        launches[path], _ = _count_launches(lambda: step(state, batch))
        want = fw.launch_counts()
        expect = {"cost_volume": 10, "cost_volume_bwd": 5,
                  "conv_group": n_diff + want["conv_group"] - n_enc,
                  "conv_group_staged": n_diff + want["conv_group_staged"] - n_enc_staged,
                  "conv_group_diff": n_diff,
                  "conv_group_q8": want["conv_group_q8"],
                  "conv_group_q8_staged": want["conv_group_q8_staged"], "gemm_probe": 0}
        print(f"main path {path} (one bf16 step) launches: {launches[path]} "
              f"(expected {expect})")
        if launches[path] != expect:
            raise AssertionError(f"{path} launch counts {launches[path]}")
        del state
    # every conv of the step is stride 1, dilation 1: all staged
    if [launches[p][k] for p in ("train", "train_q8")
            for k in ("conv_group_staged", "conv_group_q8_staged")] != [72, 0, 37, 35]:
        raise AssertionError(f"staged launches per step {launches}, want 72 / 0, 37 / 35")

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
            nbytes, ops = _cv_bwd_cost(args[0], args[3])
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
                  f"forward kernel {k_ms:.4f} ms ({_rate(flops, k_ms, bound)}), "
                  f"plain {p_ms:.4f} ms, library "
                  f"(cuDNN over the concat) {lib_ms:.4f} ms, bound {bound:.4f} ms ({by}; "
                  f"{nbytes} B, {flops} flop); backward (cuDNN conv VJPs) {bwd_ms:.4f} ms, "
                  f"library autograd {lib_bwd_ms:.4f} ms [{card}]")
    return launches


def _flownetc_grad(model, x, card):
    """FlowNetC's input gradient under a seeded cotangent on the flow (fp32,
    eval): its launches (one d=10 forward, one d=10 backward); with cuDNN's
    deterministic algorithms, against the gradient with the plain backward
    on the same forward (beside it a second run, the plain cost volume's
    gradient, and the counted run with cuDNN's default algorithms); the
    d=10 backward call against its plain version (fp32, and cast to bf16)
    and its time beside its bound. Returns the launch counts and the
    backward's numbers."""
    from ocflow_torch.bench import cuda_ms
    from ocflow_torch.kernels import cost_volume as cv_mod
    from ocflow_torch.models import flow_net_s as fns

    def flow_of(inp):
        out = model(inp)
        return out[0] if isinstance(out, tuple) else out

    with torch.no_grad():
        shape = flow_of(x).shape
    gen = torch.Generator(device=x.device).manual_seed(1)
    cot = torch.randn(shape, device=x.device, generator=gen)

    def grad():
        xg = x.detach().requires_grad_()
        return torch.autograd.grad(flow_of(xg), xg, cot)[0]

    launches, got = _count_launches(grad)
    expect = {k: 0 for k in launches}
    expect.update(cost_volume=1, cost_volume_bwd=1)
    print(f"main path flownetc input gradient (one fp32 eval forward and backward) "
          f"launches: {launches} (expected {expect})")
    if launches != expect:
        raise AssertionError(f"flownetc gradient launch counts {launches}")

    def through(forward_fn):
        """The gradient with the cost volume's forward ``forward_fn`` and the
        plain backward."""
        saved = fns.cost_volume
        fns.cost_volume = lambda a, b, d: _PlainBackward.apply(a, b, d, forward_fn)
        try:
            return grad()
        finally:
            fns.cost_volume = saved

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        det = grad()
        ref = through(cv_mod.cost_volume)
        others = {"the kernels again": grad(),
                  "the plain forward and backward": through(cv_mod.cost_volume_plain),
                  "the kernels with cuDNN's default algorithms": got}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    torch.cuda.synchronize()
    scale = ref.abs().max().item()
    rel = (det - ref).abs().max().item() / scale
    print(f"e2e flownetc input gradient (cuDNN deterministic), kernels vs the plain "
          f"backward on the same forward: {rel:.3e} of max|grad| {scale:.3e} (tol "
          f"{GRAD_FP32_TOL}); beside it, vs " + "; ".join(
              f"{k} {(r - ref).abs().max().item() / scale:.3e}" for k, r in others.items())
          + f"; finite {bool(torch.isfinite(det).all())}")
    if det.shape != x.shape or not torch.isfinite(det).all() or not rel <= GRAD_FP32_TOL:
        raise AssertionError(f"flownetc input gradient: {rel} > {GRAD_FP32_TOL}")
    del got, det, ref, others

    calls = _record([(cv_mod, "cost_volume_backward")], grad)
    if [(k, a[3]) for k, a in calls] != [("cost_volume_backward", 10)]:
        raise AssertionError(f"backward calls {[(k, a[3]) for k, a in calls]}")
    args = calls[0][1]
    err = {"cost_volume_bwd": 0.0}
    _check_float("cost_volume_bwd", args, torch.float32, err, "flownetc d=10 ")
    bf = tuple(a.bfloat16() for a in args[:3]) + (10,)
    _check_float("cost_volume_bwd", bf, torch.bfloat16, err, "flownetc d=10 ")
    res = {"max_abs_err": err["cost_volume_bwd"]}
    for dtype, a in ((torch.float32, args), (torch.bfloat16, bf)):
        k_ms = cuda_ms(lambda: cv_mod.cost_volume_backward(*a), 20)  # noqa: B023
        p_ms = cuda_ms(lambda: cv_mod.cost_volume_backward_plain(*a), 3)  # noqa: B023
        nbytes, ops = _cv_bwd_cost(a[0], 10)
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        o_ms = ops / PEAK_FLOPS[dtype] * 1e3
        by = "bytes" if b_ms >= o_ms else "operations"
        if dtype == torch.float32:
            res.update(ms=k_ms, plain_ms=p_ms, bound_ms=max(b_ms, o_ms), bound_by=by)
        print(f"time cost_volume_bwd d=10 {str(dtype)[6:]} {tuple(a[0].shape)}: kernel "
              f"{k_ms:.4f} ms ({_rate(ops, k_ms, max(b_ms, o_ms))}), plain {p_ms:.4f} ms, "
              f"library none, bound {max(b_ms, o_ms):.4f} ms ({by}; bytes {b_ms:.4f} ms "
              f"at 3.35 TB/s, operations {o_ms:.4f} ms at {PEAK_FLOPS[dtype] / 1e12:.0f} "
              f"TFLOP/s; {nbytes} B, {ops} flop) [{card}]")
    return launches, res


def _flownetc_phase(card, tf32_defaults):
    """The FlowNetC family's serving forward (B=8, 448x1024, fp32, eval, a
    seeded net with BatchNorm statistics, seed 0): launches, the d=10 call
    against its plain version (fp32, and cast to bf16), the forward against
    the plain-cost-volume forward (also with PyTorch's default TF32 flags),
    timings. Returns the launch counts per net and the d=10 call's numbers
    (FlowNetC's call)."""
    from ocflow_torch.bench import BATCH, HEIGHT, SEED, WIDTH, cuda_ms, make_flownetc_inputs
    from ocflow_torch.kernels import cost_volume as cv_mod
    from ocflow_torch.models import FlowNetC, FlowOccNetC, OcclusionNetC
    from ocflow_torch.models import flow_net_s as fns

    launches, d10, d10_bwd = {}, {"max_abs_err": 0.0}, {}
    failures = []
    for key, cls in (("flownetc", FlowNetC), ("occnetc", OcclusionNetC),
                     ("flowoccnetc", FlowOccNetC)):
        model, x = make_flownetc_inputs(BATCH, HEIGHT, WIDTH, "cuda", SEED, cls)

        def forward():
            with torch.no_grad():
                out = model(x)  # noqa: B023
            return out if isinstance(out, tuple) else (out,)

        launches[key], out = _count_launches(forward)
        expect = {k: 0 for k in launches[key]}
        expect["cost_volume"] = 1
        print(f"main path {key} (one fp32 eval forward) launches: {launches[key]} "
              f"(expected {expect})")
        if launches[key] != expect:
            raise AssertionError(f"{key} launch counts {launches[key]}")

        calls = _record([(fns, "cost_volume")], forward)
        if [(k, a[2]) for k, a in calls] != [("cost_volume", 10)]:
            raise AssertionError(f"{key}: cost-volume calls {[(k, a[2]) for k, a in calls]}")
        f1, f2, _ = calls[0][1]
        err = {"cost_volume": 0.0}
        _check_float("cost_volume", (f1, f2, 10), torch.float32, err, f"{key} d=10 ")
        _check_float("cost_volume", (f1.bfloat16(), f2.bfloat16(), 10), torch.bfloat16,
                     err, f"{key} d=10 ")
        d10["max_abs_err"] = max(d10["max_abs_err"], err["cost_volume"])

        saved, fns.cost_volume = fns.cost_volume, cv_mod.cost_volume_plain
        try:
            ref = forward()
        finally:
            fns.cost_volume = saved
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32_defaults
        try:
            out_tf32 = forward()
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        for head, o, t, r in zip(cls.HEADS, out, out_tf32, ref):
            want = (BATCH, HEIGHT, WIDTH, 2 if head == "flow" else 1)
            for v in (o, t):
                if tuple(v.shape) != want or v.dtype != torch.float32 \
                        or not torch.isfinite(v).all():
                    raise AssertionError(f"{key} {head}: bad output {v.shape} {v.dtype}")
            if head == "occ" and not (0 <= o.min().item() and o.max().item() <= 1):
                failures.append(f"{key} occ outside [0, 1]")
            scale = r.abs().max().item()
            e, e_tf32 = (o - r).abs().max().item(), (t - r).abs().max().item()
            print(f"e2e {key} {head}: kernel forward vs plain-cost-volume forward "
                  f"max_abs_err {e:.3e} (tol {E2E_FP32_TOL * scale:.3e}, max|plain| "
                  f"{scale:.3e}); with PyTorch's default TF32 flags (cudnn "
                  f"{tf32_defaults[0]}, matmul {tf32_defaults[1]}) {e_tf32:.3e} "
                  f"({e_tf32 / scale:.3e} of max|plain|, same tol)")
            if not e <= E2E_FP32_TOL * scale:
                failures.append(f"{key} {head}: kernel vs plain forward {e}")
            if not e_tf32 <= E2E_FP32_TOL * scale:
                failures.append(f"{key} {head}: default TF32 flags {e_tf32}")
        del out, out_tf32, ref

        if key == "flownetc":
            launches["flownetc_grad"], d10_bwd = _flownetc_grad(model, x, card)
            k_ms = cuda_ms(lambda: cv_mod.cost_volume(f1, f2, 10), 20)  # noqa: B023
            p_ms = cuda_ms(lambda: cv_mod.cost_volume_plain(f1, f2, 10), 3)  # noqa: B023
            nbytes, ops = _cv_cost(f1, 10)
            b_ms = nbytes / HBM_BYTES_PER_S * 1e3
            o_ms = ops / PEAK_FLOPS[torch.float32] * 1e3
            d10.update(ms=k_ms, plain_ms=p_ms, bound_ms=max(b_ms, o_ms),
                       bound_by="bytes" if b_ms >= o_ms else "operations")
            print(f"time cost_volume d=10 fp32 {tuple(f1.shape)}: kernel {k_ms:.4f} ms "
                  f"({_rate(ops, k_ms, d10['bound_ms'])}), plain {p_ms:.4f} ms, library "
                  f"none, bound {d10['bound_ms']:.4f} ms ({d10['bound_by']}; bytes "
                  f"{b_ms:.4f} ms at 3.35 TB/s, operations {o_ms:.4f} ms at 67 TFLOP/s "
                  f"fp32; {nbytes} B, {ops} flop) [{card}]")
        e2e = cuda_ms(forward, 10)
        print(f"e2e {key} fp32 eval forward B={BATCH} {HEIGHT}x{WIDTH}: {e2e:.3f} "
              f"ms/batch, {BATCH * 1e3 / e2e:.2f} pairs/s [{card}]")
        del model, x, calls, f1, f2
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))
    return launches, d10, d10_bwd


def _png_pixels(path):
    """A PNG file of the port's writer (8-bit RGB, filter 0 on every row)
    decoded with zlib: uint8 ``[H, W, 3]``."""
    import struct
    import zlib

    import numpy as np

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: not a PNG")
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if crc != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise AssertionError(f"{path}: bad CRC in {kind}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, colour = header[:4]
    if (depth, colour) != (8, 2):
        raise AssertionError(f"{path}: depth {depth}, colour type {colour}")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise AssertionError(f"{path}: a row filter other than 0")
    return rows[:, 1:].reshape(h, w, 3)


def _fit_phase(card):
    """The training system (``make_loaders`` + ``fit`` + ``evaluate`` and a
    checkpoint restore) on ``configs/longrun_synthetic.yaml`` at full width
    with ``FIT_CUTS``, outputs in a temporary directory: the dataset
    generated on the card against the CPU, the device cache's bytes, the
    launches of one train and one eval step of ``fit``, the CSV, the
    panels, the checkpoint round trip, the loop's ms per step beside
    ``bench.measure_train``'s. Returns the launch counts of that train step
    (``fit``) and eval step (``fit_eval``)."""
    import math
    import os
    import tempfile

    from ocflow_torch.bench import measure_train
    from ocflow_torch.data import SyntheticFlowWarp
    from ocflow_torch.models.pwc_net import FlowNetCV
    from ocflow_torch.train import (LONGRUN_SYNTHETIC, config_from_dict, create_train_state,
                                    loop, make_unsupervised_flow_step)
    from ocflow_torch.train_unsupervised import viz_fn
    from ocflow_torch.utils.checkpoint import CheckpointManager, load_state

    dev = torch.device("cuda")
    print("fit: configs/longrun_synthetic.yaml at full width, cut: " + ", ".join(
        f"{k} {v} (config {LONGRUN_SYNTHETIC.get(k, 'default 10')})"
        for k, v in FIT_CUTS.items()))
    with tempfile.TemporaryDirectory() as out:
        cfg = config_from_dict({
            **LONGRUN_SYNTHETIC, **FIT_CUTS, "metrics_csv": f"{out}/metrics.csv",
            "log_dir": f"{out}/tb", "checkpoint_dir": f"{out}/ckpt", "result_dir": out})
        h, w = cfg.image_size
        n = cfg.dataset_size
        split = (int(0.8 * n), int(0.1 * n), n - int(0.8 * n) - int(0.1 * n))

        # 1. data on the card vs the same samples on the CPU
        ds = SyntheticFlowWarp(size=n, image_size=(h, w), device=dev)
        ds_cpu = SyntheticFlowWarp(size=n, image_size=(h, w), device="cpu")
        for idx in (0, n - 1):
            got, ref = ds[idx], ds_cpu[idx]
            for k, tol in FIT_DATA_TOL.items():
                err = (got[k].cpu() - ref[k]).abs().max().item()
                print(f"fit data: SyntheticFlowWarp[{idx}] {k} {tuple(got[k].shape)} cuda "
                      f"vs cpu max_abs_err {err:.3e} (tol {tol})")
                if not err <= tol or got[k].device.type != "cuda":
                    raise AssertionError(f"SyntheticFlowWarp[{idx}] {k}: {err} on "
                                         f"{got[k].device}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for idx in range(8):
            ds[idx]
        torch.cuda.synchronize()
        gen_ms = (time.perf_counter() - t0) * 1e3 / 8
        t0 = time.perf_counter()
        ds_cpu[1]
        cpu_ms = (time.perf_counter() - t0) * 1e3
        print(f"fit data: SyntheticFlowWarp {h}x{w} generation on the card {gen_ms:.2f} "
              f"ms/sample (8 samples, host clock to a sync; the numpy draws included), on "
              f"this host's CPU {cpu_ms:.1f} ms [{card}]")
        del ds, ds_cpu, got, ref

        # 2. the loaders and the device cache
        train_loader, val_loader, test_loader = loop.make_loaders(cfg, dev)
        for name, ld, m in zip(("train", "val", "test"),
                               (train_loader, val_loader, test_loader), split):
            want = {"images": (m * h * w * 6 * 2, torch.bfloat16),
                    "flow": (m * h * w * 2 * 4, torch.float32)}
            got = {k: (v.numel() * v.element_size(), v.dtype)
                   for k, v in ld.cache().items()}
            print(f"fit device cache {name} ({m} samples): {got} (expected {want}; "
                  f"{sum(b for b, _ in got.values()) / 1e6:.1f} MB)")
            if got != want or any(v.device.type != "cuda"
                                  for v in ld.cache().values()):
                raise AssertionError(f"device cache {name}: {got}")

        # 3. fit, through wrappers of the step functions that count one train
        # and one eval step's launches, record a CUDA event after each train
        # step, and keep the state each epoch's checkpoint saves (validation
        # runs on the state fit then saves)
        model = FlowNetCV(displacement=cfg.displacement,
                          generator=torch.Generator().manual_seed(cfg.seed))
        state = create_train_state(model, cfg.learning_rate, device=dev)
        train_step, eval_step = make_unsupervised_flow_step(cfg.as_hparams())
        count_step = 2
        rec = {"ends": [], "snap": {}, "panels": {}, "epoch": -1}
        launches = {}

        def train_wrapped(st, batch):
            before = _read_counts() if st.step == count_step else None
            st, metrics = train_step(st, batch)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            rec["ends"].append(ev)
            if before is not None:  # the counters count on the host, at each launch
                after = _read_counts()
                launches["fit"] = {k: after[k] - before[k] for k in after}
            return st, metrics

        def eval_wrapped(st, batch):
            if st.step not in rec["snap"]:
                rec["epoch"] += 1
                rec["snap"][st.step] = (rec["epoch"], {
                    "step": st.step,
                    "params": {k: v.clone() for k, v in st.model.state_dict().items()},
                    "opt_state": copy.deepcopy(st.optimizer.state_dict())})
            if "fit_eval" in launches:
                return eval_step(st, batch)
            before = _read_counts()
            metrics = eval_step(st, batch)
            after = _read_counts()
            launches["fit_eval"] = {k: after[k] - before[k] for k in after}
            return metrics

        def viz_wrapped(st, batch):
            panels = viz_fn(st, batch)
            rec["panels"][rec["epoch"]] = panels
            return panels

        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = loop.fit(cfg, state, train_wrapped, eval_wrapped, train_loader, val_loader,
                         viz_fn=viz_wrapped)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        total = _read_counts()
        steps_per_epoch = split[0] // cfg.batch_size
        print(f"fit: {cfg.max_epochs} epochs of {steps_per_epoch} steps in {fit_s:.2f} s "
              f"wall (caches built before); launches over the whole fit {total}")
        for path, want in (("fit", FIT_STEP_LAUNCHES), ("fit_eval", None)):
            print(f"main path {path} (one {'train' if want else 'eval'} step of fit, B="
                  f"{cfg.batch_size if want else split[1]}) launches: {launches[path]}"
                  + (f" (expected {want})" if want else ""))
        if launches["fit"] != FIT_STEP_LAUNCHES:
            raise AssertionError(f"fit train step launches {launches['fit']}")
        for k in ("cost_volume", "cost_volume_bwd", "conv_group", "conv_group_diff"):
            if total[k] == 0:
                raise AssertionError(f"fit ran no {k} kernel")
        if launches["fit_eval"]["cost_volume"] == 0 or launches["fit_eval"]["conv_group"] == 0:
            raise AssertionError(f"eval step launches {launches['fit_eval']}")

        # 4. the run's records: CSV rows, finite losses, panels
        with open(cfg.metrics_csv) as f:
            lines = f.read().splitlines()
        keys = lines[0].split(",")
        rows = [dict(zip(keys, line.split(","))) for line in lines[1:]]
        n_train = sum(r["phase"] == "train" for r in rows)
        n_val = sum(r["phase"] == "val" for r in rows)
        want_rows = (cfg.max_epochs * steps_per_epoch, cfg.max_epochs)
        losses = [float(r["loss"]) for r in rows]
        print(f"fit CSV: {n_train} train rows, {n_val} val rows (expected {want_rows}); "
              f"losses {losses}")
        if (n_train, n_val) != want_rows or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"CSV rows {(n_train, n_val)}, losses {losses}")
        for epoch, panels in rec["panels"].items():
            for tag, img in panels.items():
                path = os.path.join(out, f"val_{epoch}", f"{tag}.png")
                pix = _png_pixels(path)
                print(f"fit panel val_{epoch}/{tag}.png: {pix.shape}, equal to the "
                      f"panel: {(pix == img).all()}")
                if pix.shape != (4 * h, w, 3) or not (pix == img).all():
                    raise AssertionError(f"{path}: {pix.shape}")
        if sorted(rec["panels"]) != list(range(cfg.max_epochs)) \
                or any(sorted(p) != ["flow", "warp"] for p in rec["panels"].values()):
            raise AssertionError(f"panels {[(e, sorted(p)) for e, p in rec['panels'].items()]}")

        # 5. the checkpoint: restore() into a fresh model and Adam, equal bit
        # for bit to the state fit saved; evaluate on both
        mgr = CheckpointManager(cfg.checkpoint_dir)
        best = mgr.best_step
        saved = {epoch: snap for epoch, snap in rec["snap"].values()}[best]
        restored = create_train_state(FlowNetCV(displacement=cfg.displacement),
                                      cfg.learning_rate, device=dev)
        load_state(restored, mgr.restore())
        same_params = all(torch.equal(v, saved["params"][k])
                          for k, v in restored.model.state_dict().items())
        opt_r = restored.optimizer.state_dict()
        same_opt = (opt_r["param_groups"] == saved["opt_state"]["param_groups"]
                    and all(torch.equal(v, saved["opt_state"]["state"][i][k])
                            for i, s in opt_r["state"].items() for k, v in s.items()))
        print(f"fit checkpoint: best epoch {best} of {cfg.max_epochs} (val losses "
              f"{[float(r['loss']) for r in rows if r['phase'] == 'val']}); restored "
              f"step {restored.step} (saved {saved['step']}), parameters bit for bit "
              f"{same_params}, Adam state bit for bit {same_opt}")
        if not (same_params and same_opt and restored.step == saved["step"]):
            raise AssertionError("the restored checkpoint differs from the saved state")
        if best == cfg.max_epochs - 1:
            in_memory, which = state, "the state fit returned"
        else:
            in_memory = create_train_state(FlowNetCV(displacement=cfg.displacement),
                                           cfg.learning_rate, device=dev)
            load_state(in_memory, saved)
            which = f"the state fit held at epoch {best}, kept in memory"
        t0 = time.perf_counter()
        m_restored = loop.evaluate(cfg, restored, eval_step, test_loader)
        eval_ms = (time.perf_counter() - t0) * 1e3
        m_memory = loop.evaluate(cfg, in_memory, eval_step, test_loader)
        rel = {k: abs(m_restored[k] - v) / max(abs(v), 1e-30) for k, v in m_memory.items()}
        print(f"fit evaluate (test split, {split[2]} pairs): restored {m_restored}; "
              f"{which} {m_memory}; relative difference {rel} (tol {FIT_EVAL_REL})")
        if set(m_restored) != set(m_memory) or not all(v <= FIT_EVAL_REL
                                                       for v in rel.values()):
            raise AssertionError(f"evaluate restored vs in memory: {rel}")

        # 6. timing: what fit does at each epoch's end (a checkpoint save, a
        # validation pass: here evaluate over the test split, one batch),
        # then the loop's ms per step from the CUDA events after each
        # train step (steps 3-8 of the run, leaving out each epoch's first
        # interval, which holds the validation, the panels and the save), and
        # bench.measure_train on a batch of the loader, in this process
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        CheckpointManager(f"{out}/timing").save(0, state, 0.0)
        save_ms = (time.perf_counter() - t0) * 1e3
        size = os.path.getsize(CheckpointManager(f"{out}/timing").path(0))
        print(f"fit epoch end: a checkpoint save {save_ms:.1f} ms ({size / 1e6:.1f} MB), "
              f"evaluate over {split[2]} pairs in one batch {eval_ms:.1f} ms (host clock) "
              f"[{card}]")
        ends = rec["ends"]
        firsts = set(range(0, len(ends), steps_per_epoch))
        gaps = [ends[i - 1].elapsed_time(ends[i]) for i in range(2, len(ends))
                if i not in firsts]
        loop_ms = sum(gaps) / len(gaps)
        batch = next(iter(train_loader))
        bench_state = create_train_state(copy.deepcopy(state.model), cfg.learning_rate,
                                         device=dev)
        bench = measure_train(bench_state, train_step, batch)
        print(f"fit timing: the loop {loop_ms:.3f} ms/step ({cfg.batch_size * 1e3 / loop_ms:.2f} "
              f"pairs/s; CUDA events between the ends of steps {[i + 1 for i in range(2, len(ends)) if i not in firsts]}, "
              f"intervals {[round(g, 3) for g in gaps]} ms; a metrics fetch every step), "
              f"bench.measure_train {bench['ms_per_step']:.3f} ms/step "
              f"({bench['pairs_per_sec']:.2f} pairs/s; no fetch), loop / bench "
              f"{loop_ms / bench['ms_per_step']:.3f} [{card}]")
        del state, bench_state, restored, in_memory, rec, train_loader, val_loader, test_loader
    torch.cuda.empty_cache()
    return launches


# phase 11: the file-backed data path and the serving and eval CLIs, at
# real sizes: Sintel (2 scenes of 5 frames, 436x1024, cropped to 384x1024 by
# the floor-64 rule), KITTI 2015 (3 pairs, 375x1242 -> 320x1216: level 6 is
# 19 wide) and FlyingChairs2 (24 pairs, 384x512), generated from the seed
FILES_SINTEL = (2, 5, 436, 1024)  # scenes, frames per scene, height, width
FILES_KITTI = (3, 375, 1242)      # pairs, height, width
FILES_CHAIRS2 = (24, 384, 512)    # pairs, height, width
FILES_SEED = 0
# the steady rates: evaluate over a Sintel tree of 49 frames a scene (96
# pairs, 12 batches of 8) and infer over a folder of 17 frames (16 pairs),
# both links to the generated frames, timed after the first batch / pair
FILES_STEADY_FRAMES = (49, 17)
# evaluate's EPE and occlusion F1 on the kernels vs on the plain cost
# volume, relative: the cost volume's summation order through an fp32
# forward (1e-4 of max|flow| per flow, phase 6), averaged over pixels
FILES_METRIC_REL = 1e-4


def _smooth(rng, h, w, c, lo, hi):
    """A smooth seeded field ``[h, w, c]`` in ``[lo, hi]``: uniform noise on
    a grid 16x coarser, bilinearly upsampled (float32)."""
    import numpy as np
    import torch.nn.functional as F

    coarse = torch.from_numpy(rng.uniform(lo, hi, (1, c, h // 16 + 2, w // 16 + 2))
                              .astype(np.float32))
    return F.interpolate(coarse, size=(h, w), mode="bilinear",
                         align_corners=False)[0].permute(1, 2, 0).numpy()


def _write_trees(root):
    """The three trees under ``root``, written by the port's own writers
    (every PNG with a seeded mix of the five row filters, so the decoder's
    unfiltering of each type runs). Returns ``{tree: path}`` and what was
    written of each file kind, to read back."""
    import os

    import numpy as np

    from ocflow_torch.data import write_flo
    from ocflow_torch.utils.png import write_png

    rng = np.random.default_rng(FILES_SEED)
    frame = lambda h, w: _smooth(rng, h, w, 3, 0, 255).round().astype(np.uint8)  # noqa: E731
    filters = lambda h: rng.integers(0, 5, h)  # noqa: E731
    written = {}
    sintel = os.path.join(root, "sintel")
    scenes, frames, h, w = FILES_SINTEL
    for s in range(scenes):
        for sub in ("clean", "flow", "occlusions"):
            os.makedirs(os.path.join(sintel, sub, f"scene_{s}"))
        for f in range(1, frames + 1):
            img = frame(h, w)
            path = os.path.join(sintel, "clean", f"scene_{s}", f"frame_{f:04d}.png")
            write_png(path, img, filters(h))
            written.setdefault("frame", (path, img))
            if f == frames:
                continue
            flow = _smooth(rng, h, w, 2, -20, 20)
            path = os.path.join(sintel, "flow", f"scene_{s}", f"frame_{f:04d}.flo")
            write_flo(path, flow)
            written.setdefault("flo", (path, flow))
            occ = (_smooth(rng, h, w, 1, 0, 1) > 0.7).astype(np.uint8) * 255
            path = os.path.join(sintel, "occlusions", f"scene_{s}", f"frame_{f:04d}.png")
            write_png(path, occ, filters(h))
            written.setdefault("occ", (path, occ))
    kitti = os.path.join(root, "kitti")
    n, h, w = FILES_KITTI
    for sub in ("image_2", "flow_occ"):
        os.makedirs(os.path.join(kitti, sub))
    for i in range(n):
        for suffix in ("10", "11"):
            write_png(os.path.join(kitti, "image_2", f"{i:06d}_{suffix}.png"), frame(h, w),
                      filters(h))
        flow = _smooth(rng, h, w, 2, -40, 40)
        raw = np.empty((h, w, 3), np.uint16)
        raw[..., :2] = np.clip(flow * 64.0 + 2 ** 15, 0, 65535).astype(np.uint16)
        raw[..., 2] = rng.uniform(size=(h, w)) > 0.3  # sparse: ~70% valid
        path = os.path.join(kitti, "flow_occ", f"{i:06d}_10.png")
        write_png(path, raw, filters(h))
        written.setdefault("kitti_flow", (path, raw))
    chairs2 = os.path.join(root, "chairs2")
    os.makedirs(chairs2)
    n, h, w = FILES_CHAIRS2
    for i in range(n):
        for k in (1, 2):
            write_png(os.path.join(chairs2, f"{i:05d}-img_{k}.png"), frame(h, w), filters(h))
        write_flo(os.path.join(chairs2, f"{i:05d}-flow_01.flo"), _smooth(rng, h, w, 2, -10, 10))
        write_png(os.path.join(chairs2, f"{i:05d}-occ_01.png"),
                  (_smooth(rng, h, w, 1, 0, 1) > 0.7).astype(np.uint8) * 255, filters(h))
    return {"sintel": sintel, "kitti": kitti, "chairs2": chairs2}, written


def _linked_sintel(sintel, dst, frames):
    """A Sintel tree of ``frames`` frames a scene, each file a link, in
    turn, to a frame or ``.flo`` of ``sintel``: the decode work of as many
    real files, written in no time."""
    import os

    scenes, n = FILES_SINTEL[:2]
    for s in range(scenes):
        for sub, ext, k, m in (("clean", "png", n, frames), ("flow", "flo", n - 1, frames - 1)):
            os.makedirs(os.path.join(dst, sub, f"scene_{s}"))
            for f in range(m):
                os.symlink(os.path.join(sintel, sub, f"scene_{s}", f"frame_{f % k + 1:04d}.{ext}"),
                           os.path.join(dst, sub, f"scene_{s}", f"frame_{f + 1:04d}.{ext}"))
    return dst


def _busy_share(prof, mark):
    """The card's busy share in a ``torch.profiler`` trace: the union of
    its kernels and copies from the start of the host's second ``mark``
    range to the last of them, over that window; and the window in ms.
    (The trace also holds each ``mark`` range on the device's timeline:
    not work, so left out of both.)"""
    on_card = lambda e: str(getattr(e, "device_type", "")).endswith("CUDA")  # noqa: E731
    evs = prof.events()
    starts = sorted(e.time_range.start for e in evs if e.name == mark and not on_card(e))
    dev = sorted((e.time_range.start, e.time_range.end) for e in evs
                 if on_card(e) and e.name != mark)
    if len(starts) < 2 or not dev:
        raise AssertionError(f"profiler trace: {len(starts)} {mark!r} ranges, "
                             f"{len(dev)} device events")
    t0, t1 = starts[1], max(end for _, end in dev)
    busy, at = 0.0, t0
    for a, b in dev:
        a, b = max(a, at), min(b, t1)
        if b > a:
            busy += b - a
            at = b
    return busy / (t1 - t0), (t1 - t0) / 1e3


class _Timed:
    """Wraps a module-level function: per call, the launch counts of that
    call (every counter zeroed at its start), CUDA events around it, its
    host start time and, with ``keep``, its arguments and result."""

    def __init__(self, module, name, fn=None, keep=False):
        self.module, self.name, self.keep = module, name, keep
        self.saved = getattr(module, name)
        self.fn = fn or self.saved
        self.counts, self.events, self.starts, self.calls = [], [], [], []

    def __call__(self, *args, **kwargs):
        self.starts.append(time.perf_counter())
        _zero_counts()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = self.fn(*args, **kwargs)
        end.record()
        self.counts.append(_read_counts())
        self.events.append((start, end))
        if self.keep:
            self.calls.append((args, kwargs, out))
        return out

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.saved)

    def span_ms(self, first: int = 0) -> float:
        """The CUDA-event spans of the calls from ``first`` on, summed: the
        card's work in them and its idle gaps inside them."""
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events[first:])


def _files_phase(card, max_err):
    """The file-backed data path and both CLIs on the card (see the module
    docstring, phase 11). Returns the launch counts per evaluate batch, per
    infer pair and of one train step of ``fit`` on FlyingChairs2."""
    import math
    import os
    import tempfile

    import numpy as np

    from ocflow_torch import evaluate, infer
    from ocflow_torch.bench import cuda_ms
    from ocflow_torch.data import (DataLoader, build_dataset, native_io, read_flo, read_gen,
                                   read_kitti_png_flow, write_flo)
    from ocflow_torch.kernels import cost_volume as cv_mod
    from ocflow_torch.models import flow_net_s as fns
    from ocflow_torch.models import pwc_fast, pwc_net
    from ocflow_torch.models.pwc_net import FlowNetCV
    from ocflow_torch.tools.q8_error import flow_errors
    from ocflow_torch.train import (LONGRUN_SYNTHETIC, config_from_dict, create_train_state,
                                    loop, make_unsupervised_flow_step)
    from ocflow_torch.train_unsupervised import viz_fn
    from ocflow_torch.utils.png import encode_png
    from ocflow_torch.utils.viz import flow_to_image

    dev = torch.device("cuda")
    launches, warm_ms = {}, {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        # 1. the trees, 2. read back bit for bit
        t0 = time.perf_counter()
        trees, written = _write_trees(out)
        print(f"files: wrote the Sintel ({FILES_SINTEL}), KITTI ({FILES_KITTI}) and "
              f"FlyingChairs2 ({FILES_CHAIRS2}) trees in {time.perf_counter() - t0:.2f} s "
              f"(host)")
        path, img = written["frame"]
        path_o, occ = written["occ"]
        path_f, flow = written["flo"]
        path_k, raw = written["kitti_flow"]
        kflow = read_kitti_png_flow(path_k)
        checks = {
            "frame": np.array_equal(read_gen(path), img),
            "occlusion": np.array_equal(read_gen(path_o), occ),
            ".flo": np.array_equal(read_flo(path_f), flow),
            "kitti 16-bit": (np.array_equal(kflow[..., 0], (raw[..., 0] - 2.0 ** 15) / 64.0)
                             and np.array_equal(kflow[..., 1], (raw[..., 1] - 2.0 ** 15) / 64.0)
                             and np.array_equal(kflow[..., 2], raw[..., 2]))}
        print(f"files IO: read back bit for bit {checks}")
        if not all(checks.values()):
            raise AssertionError(f"file IO round trip {checks}")

        # host decode per pair: one thread, then the loader's 6
        ds = build_dataset("MpiSintelClean", root=trees["sintel"])
        pair = ds.image_list[0]
        th, tw = sintel_hw = ds.render_size
        t0 = time.perf_counter()
        for p in ds.image_list:
            native_io.read_pair_norm(*p, th, tw)
        dec_ms = (time.perf_counter() - t0) * 1e3 / len(ds)
        with ThreadPoolExecutor(6) as pool:
            list(pool.map(lambda p: native_io.read_pair_norm(*p, th, tw), ds.image_list))
            t0 = time.perf_counter()
            for _ in range(3):
                list(pool.map(lambda p: native_io.read_pair_norm(*p, th, tw), ds.image_list))
            dec6_ms = (time.perf_counter() - t0) * 1e3 / (3 * len(ds))
        t0 = time.perf_counter()
        for i in range(len(ds)):
            ds[i]
        sample_ms = (time.perf_counter() - t0) * 1e3 / len(ds)
        loader = DataLoader(ds, len(ds), num_workers=6, drop_last=False)
        t0 = time.perf_counter()
        batch = next(iter(loader))
        loader_ms = (time.perf_counter() - t0) * 1e3 / len(ds)
        print(f"files decode: Sintel {FILES_SINTEL[2]}x{FILES_SINTEL[3]} -> {th}x{tw}, "
              f"{len(ds)} pairs ({os.path.getsize(pair[0])} B a frame): the fused decode "
              f"of a PNG pair {dec_ms:.2f} ms on one thread, {dec6_ms:.2f} ms per pair on 6 "
              f"threads (warm pool, 3 passes); a sample with its .flo {sample_ms:.2f} ms "
              f"(one thread); a batch of all {len(ds)} through the loader's 6 threads, "
              f"stacked, {loader_ms:.2f} ms per pair (host clock; {os.cpu_count()} CPUs) "
              f"[{card}]")
        if tuple(batch["images"].shape) != (len(ds), th, tw, 6):
            raise AssertionError(f"Sintel batch {batch['images'].shape}")
        del batch, loader

        # 3. evaluate --task flow --model pwc on Sintel and KITTI: on the
        # kernels (calls recorded, launches counted per batch), then on the
        # plain cost volume
        def run_eval(argv, fn_module, plain):
            """evaluate.main: its result, its cost-volume calls (the kernel
            run), its forwards' counts and events, its wall ms."""
            box = {}
            with _Timed(evaluate, "predict", keep=not plain) as timed:
                t0 = time.perf_counter()
                if plain:
                    saved = fn_module.cost_volume
                    fn_module.cost_volume = cv_mod.cost_volume_plain
                    try:
                        box["res"] = evaluate.main(argv)
                    finally:
                        fn_module.cost_volume = saved
                    calls = None
                else:
                    calls = _record([(fn_module, "cost_volume")], lambda: box.update(
                        res=evaluate.main(argv)))
                return box["res"], calls, timed, (time.perf_counter() - t0) * 1e3

        runs = [("evaluate_sintel", "MpiSintelClean", trees["sintel"], "flow", "pwc", pwc_net),
                ("evaluate_kitti", "KITTI2015", trees["kitti"], "flow", "pwc", pwc_net),
                ("evaluate_flowoccnetc", "MpiSintelFlowOccClean", trees["sintel"],
                 "flow_occ", "flowoccnetc", fns)]
        for path_name, name, root, task, model_key, fn_module in runs:
            argv = ["--task", task, "--model", model_key, "--dataset", name, "--root", root,
                    "--batch_size", "8"]
            got, calls, timed, wall = run_eval(argv, fn_module, plain=False)
            ref, _, _, _ = run_eval(argv, fn_module, plain=True)
            n = len(build_dataset(name, root=root))
            d = 10 if model_key == "flowoccnetc" else 4
            # the first batch's forward again, warm: what the card needs per batch
            (model, x), _, _ = timed.calls[0]
            fwd_ms = cuda_ms(lambda: evaluate.predict(model, x), 3)  # noqa: B023
            del model, x, timed.calls[:]
            for k, (_, args) in enumerate(calls):
                _check_float("cost_volume", args, torch.float32, max_err,
                             f"{path_name} d={d} call {k} ")
            expect = {k: 0 for k in timed.counts[0]}
            expect["cost_volume"] = 1 if d == 10 else 5
            launches[path_name] = timed.counts[0]
            warm_ms[path_name] = fwd_ms
            span = timed.span_ms()
            rel = {k: abs(got[k] - v) / max(abs(v), 1e-30) for k, v in ref.items()}
            shape = tuple(calls[0][1][0].shape) if calls else None
            print(f"main path {path_name} ({name}, {n} pairs, batches "
                  f"{[c['cost_volume'] for c in timed.counts]} cost volumes each) launches "
                  f"per batch: {timed.counts} (expected {expect} each)")
            print(f"e2e {path_name}: {got} on the kernels, {ref} on the plain cost volume, "
                  f"relative {rel} (tol {FILES_METRIC_REL}); {n} pairs in {wall:.1f} ms wall "
                  f"({n * 1e3 / wall:.2f} pairs/s end to end, the model's build and the cold "
                  f"first forward included), the forwards' CUDA-event span {span:.1f} ms "
                  f"({100 * span / wall:.1f}% of the wall; idle gaps inside counted); the "
                  f"same forward warm {fwd_ms:.2f} ms per "
                  f"batch of {len(calls and calls[0][1][0]) or 0}); the first cost volume "
                  f"{shape} [{card}]")
            if any(c != expect for c in timed.counts) or len(calls) != len(timed.counts) * \
                    expect["cost_volume"]:
                raise AssertionError(f"{path_name} launches {timed.counts}")
            if set(got) != set(ref) or not all(v <= FILES_METRIC_REL for v in rel.values()) \
                    or not all(math.isfinite(v) for v in got.values()):
                raise AssertionError(f"{path_name}: {got} vs {ref}")
            if task == "flow_occ" and "occlusion_f1" not in got:
                raise AssertionError(f"{path_name}: no occlusion F1")
            # KITTI's crop 1216 wide: levels 19, 38, 76, 152, 304 wide
            tw = FILES_KITTI[2] // 64 * 64
            if model_key == "pwc" and name.startswith("KITTI") and sorted(
                    {a[0].shape[-1] for _, a in calls}) != [tw >> k for k in (6, 5, 4, 3, 2)]:
                raise AssertionError(f"KITTI widths {[a[0].shape for _, a in calls]}")
            del calls

        # evaluate's steady rate: 12 batches of 8 from a tree of links,
        # timed from the second batch's forward to the end (the model's
        # build and the cold first batch left out), then again under
        # torch.profiler for the card's busy share in that window
        from torch.profiler import ProfilerActivity, profile, record_function

        from ocflow_torch.models import predict

        def marked(model, x):
            with record_function("evaluate.predict"):
                return predict(model, x)

        root = _linked_sintel(trees["sintel"], os.path.join(out, "sintel_steady"),
                              FILES_STEADY_FRAMES[0])
        argv = ["--task", "flow", "--model", "pwc", "--dataset", "MpiSintelClean", "--root",
                root, "--batch_size", "8"]
        n = len(build_dataset("MpiSintelClean", root=root))
        rates = []
        for traced in (False, True):
            with _Timed(evaluate, "predict", fn=marked) as timed, (
                    profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                    if traced else contextlib.nullcontext()) as prof:
                res = evaluate.main(argv)
                t_end = time.perf_counter()
            window = (t_end - timed.starts[1]) * 1e3
            rates.append((n - 8) * 1e3 / window)
            if not traced:
                per_batch, span = window / (len(timed.starts) - 1), timed.span_ms(1)
                batches, first_ms = len(timed.starts), (timed.starts[1] - timed.starts[0]) * 1e3
        busy, traced_ms = _busy_share(prof, "evaluate.predict")
        print(f"e2e evaluate_steady (MpiSintelClean, {n} pairs of {sintel_hw}, {batches} "
              f"batches of 8): {rates[0]:.2f} pairs/s from the second batch's forward to "
              f"the end ({per_batch:.1f} ms a batch; the first batch {first_ms:.1f} ms); "
              f"beside it the decode of 8 pairs on 6 threads {8 * dec6_ms:.1f} ms and the "
              f"warm forward {warm_ms['evaluate_sintel']:.2f} ms a batch; the forwards' "
              f"CUDA-event span {100 * span / window:.1f}% of the window (idle gaps inside "
              f"counted); under torch.profiler {rates[1]:.2f} pairs/s, the card busy "
              f"{100 * busy:.1f}% of {traced_ms:.1f} ms (kernels and copies, union); epe "
              f"{res['epe']:.4f} [{card}]")
        if not (batches == n // 8 and all(math.isfinite(r) and r > 0 for r in rates)
                and 0 < busy <= 1 and math.isfinite(res["epe"])):
            raise AssertionError(f"evaluate_steady: {batches} batches, {rates}, busy {busy}")
        del prof, timed

        # 5. infer --q8 --save_flo pair by pair on Sintel and KITTI frames
        targets = [(pwc_fast, n) for n in ("cost_volume", "conv_group", "conv_group_q8")]
        linked = _linked_sintel(trees["sintel"], os.path.join(out, "sintel_infer"),
                                FILES_STEADY_FRAMES[1])
        for path_name, frames in (("infer_q8", os.path.join(linked, "clean", "scene_0")),
                                  ("infer_q8_kitti", os.path.join(trees["kitti"], "image_2"))):
            dst = os.path.join(out, path_name)
            first = {}

            def fast(model, x, q8=None, device=None):
                if not first:  # the first pair: every kernel call recorded
                    first["calls"] = _record(targets, lambda: first.update(
                        out=pwc_fast.fast_apply(model, x, q8=q8, device=device)))
                    first.update(model=model, x=x, q8=q8)
                    return first["out"]
                return pwc_fast.fast_apply(model, x, q8=q8, device=device)

            with _Timed(infer, "fast_apply", fn=fast, keep=True) as timed:
                t0 = time.perf_counter()
                paths = infer.main(["--input", frames, "--output", dst, "--save_flo", "--q8"])
                wall = (time.perf_counter() - t0) * 1e3
            n = len(timed.calls)
            for kind, args in first["calls"]:
                if kind == "conv_group_q8":
                    _check_q8(args, max_err, f"{path_name} ")
                else:
                    _check_float(kind, args, torch.float32, max_err, f"{path_name} ")
            same = [np.array_equal(read_flo(paths[2 * i + 1]), out_[0][0].cpu().numpy())
                    for i, (_, _, out_) in enumerate(timed.calls)]
            with torch.no_grad(), _plain_eager_cost_volume():
                ref = first["model"](first["x"])
            e = flow_errors(timed.calls[0][2][1], ref[1])
            want = pwc_fast.prepare(first["model"], torch.float32, dev,
                                    first["q8"]).launch_counts()
            expect = {"cost_volume": 5, "cost_volume_bwd": 0, "conv_group_diff": 0, **want,
                      "gemm_probe": 0}
            launches[path_name] = timed.counts[0]
            steady = np.diff(timed.starts) * 1e3  # ms from one pair's start to the next
            # the host's share of a pair: colouring, PNG encode, .flo write
            flow0 = timed.calls[-1][2][0][0].cpu().numpy()
            host = {}
            for what, fn in (("flow_to_image", lambda: flow_to_image(flow0)),  # noqa: B023
                             ("PNG encode", lambda: encode_png(flow_to_image(flow0))),  # noqa: B023
                             (".flo write", lambda: write_flo(  # noqa: B023
                                 os.path.join(out, "t.flo"), flow0))):
                t0 = time.perf_counter()
                fn()
                host[what] = (time.perf_counter() - t0) * 1e3
            host["PNG encode"] -= host["flow_to_image"]
            shape = tuple(first["x"].shape)
            print(f"main path {path_name} ({n} pairs of {shape}) launches per pair: "
                  f"{timed.counts[0]} (expected {expect}; all pairs equal: "
                  f"{all(c == expect for c in timed.counts)})")
            print(f"e2e {path_name}: .flo files equal to fast_apply's flow bit for bit "
                  f"{same}; the W8A8 quarter flow vs the eager fp32 forward (plain cost "
                  f"volume) max_abs_err {e['max_abs']:.3e} ({e['max_abs_rel']:.4f} of "
                  f"max|flow_quarter|, tol {E2E_Q8_TOL['w8a8']}); {n} pairs in {wall:.1f} ms "
                  f"wall ({n * 1e3 / wall:.2f} pairs/s end to end, the model's build and the "
                  f"calibration included; {1e3 / steady.mean():.2f} pairs/s between the "
                  f"pairs after the first, {steady.mean():.1f} ms per pair), fast_apply's "
                  f"CUDA-event span {timed.span_ms():.1f} ms (per pair "
                  f"{[round(a.elapsed_time(b), 2) for a, b in timed.events]} ms, idle gaps "
                  f"inside counted; the first with its calls recorded); host ms per pair "
                  f"{host} [{card}]")
            if any(c != expect for c in timed.counts) or (want["conv_group"],
                                                          want["conv_group_q8"]) != (24, 35):
                raise AssertionError(f"{path_name} launches {timed.counts}")
            if not all(same) or len(paths) != 2 * n or not e["max_abs_rel"] <= E2E_Q8_TOL["w8a8"]:
                raise AssertionError(f"{path_name}: flo {same}, W8A8 {e}")
            del first, timed, ref

        # 6. one epoch of fit on FlyingChairs2 through make_loaders (root,
        # device cache), the longrun hparams, one train step's kernel calls
        # replayed and its launches counted
        cfg = config_from_dict({
            **LONGRUN_SYNTHETIC, "dataset_name": "FlyingChairs2", "root": trees["chairs2"],
            "image_size": None, "dataset_size": None, "max_epochs": 1,
            "log_every_n_steps": 1, "num_workers": 6, "metrics_csv": f"{out}/fit.csv",
            "log_dir": f"{out}/tb", "checkpoint_dir": f"{out}/ckpt",
            "result_dir": f"{out}/fit"})
        t0 = time.perf_counter()
        train_loader, val_loader, test_loader = loop.make_loaders(cfg, dev)
        cache = train_loader.cache()
        cache_s = time.perf_counter() - t0
        n, h, w = FILES_CHAIRS2
        n_train = int(0.8 * n)
        want = {"images": ((n_train, h, w, 6), torch.bfloat16),
                "flow": ((n_train, h, w, 2), torch.float32),
                "occ": ((n_train, h, w, 1), torch.bfloat16)}  # 0/1: exact in bf16
        got = {k: (tuple(v.shape), v.dtype) for k, v in cache.items()}
        print(f"fit files: FlyingChairs2 {h}x{w} through make_loaders (root, device cache): "
              f"train cache {got} (expected {want}), built in {cache_s:.2f} s [{card}]")
        if got != want or any(v.device.type != dev.type for v in cache.values()):
            raise AssertionError(f"FlyingChairs2 cache {got}")
        model = FlowNetCV(displacement=cfg.displacement,
                          generator=torch.Generator().manual_seed(cfg.seed))
        state = create_train_state(model, cfg.learning_rate, device=dev)
        train_step, eval_step = make_unsupervised_flow_step(cfg.as_hparams())
        names = {"cost_volume_backward": "cost_volume_bwd"}
        step_targets = [(pwc_fast, "cost_volume"), (pwc_fast, "conv_group"),
                        (pwc_fast, "conv_group_diff"), (cv_mod, "cost_volume_backward")]
        rec = {}

        def train_wrapped(st, batch):
            if st.step == 0:
                box = {}
                rec["calls"] = _record(step_targets, lambda: box.update(
                    r=train_step(st, batch)))
                return box["r"]
            before = _read_counts()
            r = train_step(st, batch)
            after = _read_counts()
            rec["launches"] = {k: after[k] - before[k] for k in after}
            return r

        t0 = time.perf_counter()
        state = loop.fit(cfg, state, train_wrapped, eval_step, train_loader, val_loader,
                         viz_fn=viz_fn)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        for kind, args in rec["calls"]:
            _check_float(names.get(kind, kind), args, torch.bfloat16, max_err, "fit files ")
        launches["fit_files"] = rec["launches"]
        test = loop.evaluate(cfg, state, eval_step, test_loader)
        print(f"main path fit_files (one bf16 train step of fit, B={cfg.batch_size}, "
              f"{h}x{w}) launches: {rec['launches']} (expected {FIT_STEP_LAUNCHES}); "
              f"{len(rec['calls'])} kernel calls of the first step replayed; one epoch of "
              f"{n_train // cfg.batch_size} steps in {fit_s:.2f} s wall; test {test} [{card}]")
        if rec["launches"] != FIT_STEP_LAUNCHES or state.step != n_train // cfg.batch_size \
                or not all(math.isfinite(v) for v in test.values()) or "occ_error" not in test:
            raise AssertionError(f"fit on FlyingChairs2: {rec['launches']}, step "
                                 f"{state.step}, test {test}")
        del state, rec, train_loader, val_loader, test_loader, cache
    torch.cuda.empty_cache()
    print(f"files: phase 11 took {time.perf_counter() - t_phase:.1f} s wall")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from ocflow_torch.bench import (BATCH, HEIGHT, SEED, WIDTH, calibration_batch,
                                    cuda_ms, gpu_info, make_inputs, measure)
    from ocflow_torch.data import native_io
    from ocflow_torch.kernels import _build, conv_chain, conv_chain_q8
    from ocflow_torch.kernels import cost_volume as cv_mod
    from ocflow_torch.models import pwc_fast
    from ocflow_torch.tools import spike_int8
    from ocflow_torch.tools.q8_error import flow_errors

    # PyTorch's own TF32 flags, read once for phase 6; off everywhere else
    tf32_defaults = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = gpu_info()
    print(card)  # name, power limit: the line nvidia-smi gives
    dev = torch.device("cuda")

    # 2. build: the kernels (one nvcc each) and the host decoder (g++), all
    # started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(native_io.build)
        built = _build.build_all()
        built["host decoder (g++)"] = host.result()
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
    want = {"bf16": pwc_fast.prepare(model_b, torch.bfloat16, dev).launch_counts()}
    want.update({mode: pwc_fast.prepare(model_b, torch.bfloat16, dev, sc).launch_counts()
                 for mode, sc in scales.items()})
    launches, outs = {}, {}
    launches["bf16"], outs["bf16"] = _count_launches(
        lambda: pwc_fast.fast_apply(model_b, xb))
    for mode, sc in scales.items():
        launches[mode], outs[mode] = _count_launches(
            lambda: pwc_fast.fast_apply(model_b, xb, q8=sc))  # noqa: B023
    launches["spike_int8"], gemm_res = _count_launches(
        spike_int8.probe)
    for path in want:
        expect = {"cost_volume": 5, "cost_volume_bwd": 0, "conv_group_diff": 0,
                  **want[path], "gemm_probe": 0}
        print(f"main path {path} launches: {launches[path]} (expected {expect})")
        if launches[path] != expect:
            raise AssertionError(f"{path} launch counts {launches[path]}")
    # staged: every bf16 conv but the encoders' six stride-2 convs, every
    # int8 conv of the default W8A8 forward
    counted = ("conv_group", "conv_group_staged", "conv_group_q8", "conv_group_q8_staged")
    if [launches[p][k] for p in ("bf16", "w8a8") for k in counted] \
            != [59, 53, 0, 0, 24, 18, 35, 35]:
        raise AssertionError(f"launches {launches}, want 59 / 53 / 0 / 0 and 24 / 18 / 35 / 35")
    print(f"main path spike_int8 launches: {launches['spike_int8']}")
    if launches["spike_int8"]["gemm_probe"] < 2:
        raise AssertionError("the GEMM probe did not launch its kernel")
    for name, r in gemm_res.items():
        print(f"check gemm_probe {name} {spike_int8.SIZE}^3: max_abs_err "
              f"{r['max_abs_err']:.3e} ({'exact required' if name == 'int8' else '1e-2 of max|plain|'})")

    # 6. end to end; fp32 fast_apply once more with PyTorch's default TF32
    # flags (a user's run; fast_apply pins its fp32 cuDNN convolutions),
    # against the same eager forward (TF32 off)
    out_f = pwc_fast.fast_apply(model, x32)
    with torch.no_grad(), _plain_eager_cost_volume():
        ref = model(x32)
    # the eager FlowNetCV itself on the cost-volume kernel (5 levels)
    launches["eager"], out_eager = _count_launches(lambda: _no_grad(model, x32))
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32_defaults
    try:
        out_tf32 = pwc_fast.fast_apply(model, x32)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
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
        err_tf32 = (out_tf32[i] - r).abs().max().item()
        eb = flow_errors(outs["bf16"][i], r)
        print(f"e2e {name}: fp32 fast vs eager max_abs_err {err32:.3e} "
              f"(tol {E2E_FP32_TOL * scale:.3e}, max|eager| {scale:.3e}); with "
              f"PyTorch's default TF32 flags (cudnn {tf32_defaults[0]}, matmul "
              f"{tf32_defaults[1]}) {err_tf32:.3e} ({err_tf32 / scale:.3e} of "
              f"max|eager|, same tol); bf16 vs fp32 rel_l2 {eb['rel_l2']:.4f} (tol "
              f"{E2E_BF16_REL_L2}) max_abs_err {eb['max_abs']:.3e}")
        if not err32 <= E2E_FP32_TOL * scale:
            failures.append(f"{name}: fp32 fast_apply vs eager {err32}")
        if not err_tf32 <= E2E_FP32_TOL * scale:
            failures.append(f"{name}: fp32 fast_apply, default TF32 flags, vs eager {err_tf32}")
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
    expect = {k: 0 for k in launches["eager"]}
    expect["cost_volume"] = 5
    print(f"main path eager (the eager fp32 FlowNetCV forward) launches: "
          f"{launches['eager']} (expected {expect})")
    if launches["eager"] != expect:
        raise AssertionError(f"eager launch counts {launches['eager']}")
    for name, o, r in zip(("full", "quarter"), out_eager, ref):
        scale = r.abs().max().item()
        e = (o - r).abs().max().item()
        print(f"e2e {name}: eager fp32 FlowNetCV on the cost-volume kernel vs on the "
              f"plain cost volume max_abs_err {e:.3e} (tol {E2E_FP32_TOL * scale:.3e}, "
              f"max|plain| {scale:.3e})")
        if not e <= E2E_FP32_TOL * scale:
            failures.append(f"{name}: eager kernel vs plain cost volume {e}")
    del out_eager
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
        print(f"time {kind} bf16 {shape}: kernel {k_ms:.4f} ms ({_rate(flops, k_ms, bound)}), "
              f"plain {p_ms:.4f} ms, library "
              f"{lib_ms if lib_ms is None else round(lib_ms, 4)} ms, "
              f"bound {bound:.4f} ms ({by}; {nbytes} B, {flops} flop) [{card}]")

    p = per["cost_volume"]
    print(f"time cost_volume d=4 sum over the bf16 forward's 5 levels: kernel "
          f"{p['ms']:.4f} ms, plain {p['plain_ms']:.4f} ms, bound {p['bound_ms']:.4f} ms "
          f"({100 * p['bound_ms'] / p['ms']:.2f}% of bound) [{card}]")

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
        per["conv_group_q8"]["yard_ms"] = per["conv_group_q8"].get("yard_ms", 0.0) + yard_ms
        shape = tuple(inputs[0].shape)
        print(f"time conv_group_q8 w8a8 {shape} ({group.n_int8} int8 convs): kernel "
              f"{k_ms:.4f} ms ({ops / k_ms / 1e9:.1f} TOP/s, {100 * bound / k_ms:.2f}% of "
              f"bound), plain {p_ms:.4f} ms, library none (bf16 cuDNN conv of the same "
              f"shapes {yard_ms:.4f} ms), bound {bound:.4f} ms ({by}; {nbytes} B, "
              f"{ops} op) [{card}]")
    for kind in ("conv_group", "conv_group_q8"):
        p = per[kind]
        print(f"time {kind} sum over the {'bf16' if kind == 'conv_group' else 'w8a8'} "
              f"forward's groups: kernel {p['ms']:.4f} ms, bound {p['bound_ms']:.4f} ms "
              f"({100 * p['bound_ms'] / p['ms']:.2f}% of bound), cuDNN "
              f"{p.get('yard_ms', p['library_ms']):.4f} ms [{card}]")
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

    # 9. the FlowNetC family, d=10
    fnetc_launches, d10, d10_bwd = _flownetc_phase(card, tf32_defaults)
    launches.update(fnetc_launches)

    # 10. the training system: loaders, fit, evaluate, a checkpoint restore
    launches.update(_fit_phase(card))

    # 11. the file-backed data path and the serving and eval CLIs
    launches.update(_files_phase(card, max_err))

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
            **({"staged_launches_by_path": {k: c[f"{name}_staged"]
                                            for k, c in launches.items()}}
               if name in ("conv_group", "conv_group_q8") else {}),
            "max_abs_err": max_err[name], "ms": p["ms"],
            "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"],
            "bound_by": p["bound_by"],
            "library_ms": p["library_ms"] if name in (
                "conv_group", "conv_group_diff", "gemm_probe") else None,
            **({"library_reason": NO_LIBRARY[name]} if name in NO_LIBRARY else {}),
            **{k: p[k] for k in ("bwd_ms", "library_bwd_ms", "yard_ms") if k in p},
        })
        if name == "cost_volume":
            # the numbers above are the d=4 calls of the bf16 forward; the
            # d=10 call of one FlowNetC forward, fp32, beside them
            kernels[-1].update(d=4, **{f"{k}_d10": v for k, v in d10.items()})
        if name == "cost_volume_bwd":
            # the d=4 calls of the bf16 step; the d=10 call of FlowNetC's
            # input gradient, fp32, beside them
            kernels[-1].update(d=4, launches_d10=launches["flownetc_grad"][name],
                               **{f"{k}_d10": v for k, v in d10_bwd.items()})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
