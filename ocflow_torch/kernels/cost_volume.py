"""Cost volume, differentiable: the Hopper kernels ``csrc/cost_volume.cu``
(forward) and ``csrc/cost_volume_bwd.cu`` (backward), tuned for d = 1..10,
the general kernels ``csrc/cost_volume_any.cu`` for d > 10, and their plain
versions.

Replaces ``ocflow_tpu/ops/pallas/cost_volume_kernel.py``: the forward
``_forward_pallas`` (reached from ``cost_volume_fused`` /
``cost_volume_fused_flat``) and the VJP of ``cost_volume_fused`` (``_bwd``
-> ``_bwd_xla_mirror``). The wrapper takes ``[B, C, H, W]`` features and
returns ``[B, (2d+1)^2, H, W]`` (the channel-major layout the decoders
read). A CPU tensor goes to the plain version; a CUDA tensor launches a
kernel or raises. The tuned kernels are compiled for every d from 1 to
``MAX_DISPLACEMENT`` = 10 (d = 4, 81 shifts, the FlowNetCV path and the d=4
nets; d = 10, 441 shifts, the FlowNetC family; the others for a net built
with another ``displacement``): a thread there keeps (2d+1) x 4 fp32 values
in registers, and at d = 10 the fp32 kernels already spill. Every d above
goes to the general kernels, as the reference takes its XLA cost volume
wherever its Pallas block does not fit: staged tiles with the shift rows
and shift columns in groups (the backward in gather form, no atomics), d a
runtime argument, so one build serves every d; d < 1 raises before a
launch.

Under autograd (an input that requires grad, grad mode on) ``cost_volume``
runs through ``_CostVolume``, whose backward is ``cost_volume_backward``:
a backward kernel on CUDA, ``cost_volume_backward_plain`` on the CPU.
``cost_volume.launches`` counts forward launches and
``cost_volume_backward.launches`` backward launches, of either kernel;
``cost_volume.general_launches`` and ``cost_volume_backward.general_launches``
count those of the general kernels among them.

What bounds each kernel on the card differs with d and C: bytes at d=4
and small C, fp32 operations at d=10 and C=256 (see the source notes in
``csrc/``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ocflow_torch.kernels import _build
from ocflow_torch.ops.cost_volume import cost_volume as cost_volume_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the largest d of the tuned kernels, one configuration line per d in
# csrc/cost_volume.cu and csrc/cost_volume_bwd.cu; larger d run on
# csrc/cost_volume_any.cu
MAX_DISPLACEMENT = 10
FORWARD_DISPLACEMENTS = BACKWARD_DISPLACEMENTS = tuple(range(1, MAX_DISPLACEMENT + 1))


def _check_displacement(what: str, d: int) -> None:
    if d < 1:
        raise ValueError(f"{what}: the displacement must be at least 1, got d={d}")


def _fn(name: str, symbol: str, n_ptr: int):
    fn = getattr(_build.load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * n_ptr
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_tensors(what: str, *ts: torch.Tensor) -> None:
    f1 = ts[0]
    if f1.device.type != "cuda" or any(t.device != f1.device for t in ts):
        raise ValueError(f"{what}: unsupported devices {[t.device for t in ts]}")
    if f1.dtype not in _DTYPES or any(t.dtype != f1.dtype for t in ts):
        raise ValueError(f"{what}: unsupported dtypes {[t.dtype for t in ts]}")
    if f1.dim() != 4 or ts[1].shape != f1.shape:
        raise ValueError(f"{what}: shapes {[tuple(t.shape) for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{what}: inputs must be contiguous NCHW")


def _forward(f1: torch.Tensor, f2: torch.Tensor, max_displacement: int) -> torch.Tensor:
    if f1.device.type == "cpu":
        return cost_volume_plain(f1, f2, max_displacement)
    _check_displacement("cost_volume: forward", max_displacement)
    _check_tensors("cost_volume", f1, f2)
    b, c, h, w = f1.shape
    n = 2 * max_displacement + 1
    out = torch.empty((b, n * n, h, w), dtype=f1.dtype, device=f1.device)
    stream = torch.cuda.current_stream(f1.device).cuda_stream
    general = max_displacement > MAX_DISPLACEMENT
    name, symbol = (("cost_volume_any", "ocf_cost_volume_any_fwd") if general
                    else ("cost_volume", "ocf_cost_volume_fwd"))
    code = _fn(name, symbol, 3)(
        _DTYPES[f1.dtype], f1.data_ptr(), f2.data_ptr(), out.data_ptr(), b, c,
        h, w, max_displacement, stream)
    _build.check(code, "cost_volume")
    cost_volume.launches += 1
    cost_volume.general_launches += general
    return out


def cost_volume_backward_plain(f1: torch.Tensor, f2: torch.Tensor,
                               g: torch.Tensor, max_displacement: int = 4):
    """Plain version of the backward (port of ``_bwd_xla_mirror``):
    (2d+1)^2 shifted products each for ``df1`` and ``df2``, fp32
    accumulation (fp64 for fp64 input), returned in the input dtype.
    ``g``: ``[B, (2d+1)^2, H, W]``."""
    _, c, h, w = f1.shape
    d = max_displacement
    n = 2 * d + 1
    acc = torch.promote_types(f1.dtype, torch.float32)
    a1 = f1.to(acc)
    f2p = F.pad(f2.to(acc), (d, d, d, d))
    df1 = torch.zeros_like(a1)
    df2 = torch.zeros_like(a1)
    for i in range(n):
        for j in range(n):
            gk = g[:, i * n + j:i * n + j + 1].to(acc)
            df1 += gk * f2p[:, :, i:i + h, j:j + w]
            q = F.pad(gk * a1, (d, d, d, d))
            df2 += q[:, :, 2 * d - i:2 * d - i + h, 2 * d - j:2 * d - j + w]
    inv_c = 1.0 / c
    return (df1 * inv_c).to(f1.dtype), (df2 * inv_c).to(f2.dtype)


def cost_volume_backward(f1: torch.Tensor, f2: torch.Tensor, g: torch.Tensor,
                         max_displacement: int = 4):
    """``(df1, df2)`` of the cost volume for its cotangent ``g``; kernel on
    CUDA, plain version on the CPU."""
    if f1.device.type == "cpu":
        return cost_volume_backward_plain(f1, f2, g, max_displacement)
    _check_displacement("cost_volume_backward: backward", max_displacement)
    _check_tensors("cost_volume_backward", f1, f2, g)
    b, c, h, w = f1.shape
    if g.shape != (b, (2 * max_displacement + 1) ** 2, h, w):
        raise ValueError(f"cost_volume_backward: cotangent {tuple(g.shape)}")
    df1 = torch.empty_like(f1)
    df2 = torch.empty_like(f2)
    stream = torch.cuda.current_stream(f1.device).cuda_stream
    general = max_displacement > MAX_DISPLACEMENT
    name, symbol = (("cost_volume_any", "ocf_cost_volume_any_bwd") if general
                    else ("cost_volume_bwd", "ocf_cost_volume_bwd"))
    code = _fn(name, symbol, 5)(
        _DTYPES[f1.dtype], f1.data_ptr(), f2.data_ptr(), g.data_ptr(),
        df1.data_ptr(), df2.data_ptr(), b, c, h, w, max_displacement, stream)
    _build.check(code, "cost_volume_backward")
    cost_volume_backward.launches += 1
    cost_volume_backward.general_launches += general
    return df1, df2


class _CostVolume(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f1, f2, max_displacement):
        ctx.save_for_backward(f1, f2)
        ctx.max_displacement = max_displacement
        return _forward(f1, f2, max_displacement)

    @staticmethod
    def backward(ctx, g):
        f1, f2 = ctx.saved_tensors
        df1, df2 = cost_volume_backward(f1, f2, g.contiguous(), ctx.max_displacement)
        return df1, df2, None


def cost_volume(f1: torch.Tensor, f2: torch.Tensor,
                max_displacement: int = 4) -> torch.Tensor:
    """Correlation cost volume; kernel on CUDA, plain version on the CPU;
    differentiable in ``f1`` and ``f2``."""
    if torch.is_grad_enabled() and (f1.requires_grad or f2.requires_grad):
        return _CostVolume.apply(f1, f2, max_displacement)
    return _forward(f1, f2, max_displacement)


cost_volume.launches = cost_volume.general_launches = 0
cost_volume_backward.launches = cost_volume_backward.general_launches = 0
