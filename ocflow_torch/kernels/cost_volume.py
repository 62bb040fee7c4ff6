"""Cost-volume forward: the Hopper kernel ``csrc/cost_volume.cu`` and its
plain version.

Replaces ``ocflow_tpu/ops/pallas/cost_volume_kernel.py:_forward_pallas``
(reached from ``cost_volume_fused`` / ``cost_volume_fused_flat``). The
wrapper takes ``[B, C, H, W]`` features and returns ``[B, (2d+1)^2, H, W]``
(the channel-major layout the decoders read). A CPU tensor goes to the plain
version (``ocflow_torch.ops.cost_volume.cost_volume``); a CUDA tensor
launches the kernel or raises. Only d = 4 (81 shifts, the FlowNetCV path)
is compiled.

Bound: memory (see the source note in ``csrc/cost_volume.cu``).
"""

from __future__ import annotations

import ctypes

import torch

from ocflow_torch.kernels import _build
from ocflow_torch.ops.cost_volume import cost_volume as cost_volume_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_DISPLACEMENT = 4


def _lib():
    lib = _build.load("cost_volume")
    fn = lib.ocf_cost_volume_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def cost_volume(f1: torch.Tensor, f2: torch.Tensor,
                max_displacement: int = 4) -> torch.Tensor:
    """Correlation cost volume; kernel on CUDA, plain version on the CPU."""
    if f1.device.type == "cpu":
        return cost_volume_plain(f1, f2, max_displacement)
    if f1.device.type != "cuda" or f2.device != f1.device:
        raise ValueError(f"cost_volume: unsupported devices {f1.device}, {f2.device}")
    if f1.dtype not in _DTYPES or f2.dtype != f1.dtype:
        raise ValueError(f"cost_volume: unsupported dtypes {f1.dtype}, {f2.dtype}")
    if f1.dim() != 4 or f1.shape != f2.shape:
        raise ValueError(f"cost_volume: shapes {tuple(f1.shape)} vs {tuple(f2.shape)}")
    if not (f1.is_contiguous() and f2.is_contiguous()):
        raise ValueError("cost_volume: inputs must be contiguous NCHW")
    if max_displacement != KERNEL_DISPLACEMENT:
        raise ValueError(
            f"cost_volume: the kernel is built for d={KERNEL_DISPLACEMENT}, "
            f"got d={max_displacement}")
    b, c, h, w = f1.shape
    n = 2 * max_displacement + 1
    out = torch.empty((b, n * n, h, w), dtype=f1.dtype, device=f1.device)
    stream = torch.cuda.current_stream(f1.device).cuda_stream
    code = _lib()(_DTYPES[f1.dtype], f1.data_ptr(), f2.data_ptr(),
                  out.data_ptr(), b, c, h, w, max_displacement, stream)
    _build.check(code, "cost_volume")
    cost_volume.launches += 1
    return out


cost_volume.launches = 0
