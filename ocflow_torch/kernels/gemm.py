"""GEMM probe: the Hopper kernel ``csrc/gemm_probe.cu`` and its plain version.

Replaces ``tools/spike_int8.py:make_pallas`` (the TPU's int8 / bf16 matrix
unit probe). ``gemm(a, b)`` computes ``a @ b`` for row-major ``[M, K]`` and
``[K, N]`` matrices: int8 inputs give an exact int32 product, bf16 inputs
an fp32 product with fp32 accumulation. A CPU tensor goes to the plain
version ``gemm_plain``; any other raises unless it is a CUDA tensor on the
kernel's tile grid (``TILE``), which launches the kernel (``gemm.launches``
counts the launches).

Not on a model path: ``ocflow_torch.tools.spike_int8`` times it against
the library GEMMs to show what a hand-written tensor-core kernel reaches
on the card (bound: operations, see the source note).
"""

from __future__ import annotations

import ctypes

import torch

from ocflow_torch.kernels import _build

_DTYPES = {torch.int8: (0, torch.int32), torch.bfloat16: (1, torch.float32)}
# the kernel's tile grid: M, N and K multiples (K: 128 bytes)
TILE = {torch.int8: (256, 128, 128), torch.bfloat16: (128, 256, 64)}


def gemm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8: the exact product (float64 holds every int32 sum up to K =
    2^53 / 127^2), as int32. bf16: an fp32 product of the bf16 values (no
    TF32: a float32 matmul on the card runs in full fp32 unless allowed)."""
    if a.dtype == torch.int8:
        return (a.double() @ b.double()).to(torch.int32)
    return a.float() @ b.float()


def _lib():
    lib = _build.load("gemm_probe")
    fn = lib.ocf_gemm
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b``: int8 -> int32 or bf16 -> fp32. Kernel on CUDA, plain
    version on the CPU."""
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise ValueError(f"gemm: unsupported dtypes {a.dtype}, {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm: shapes {tuple(a.shape)} x {tuple(b.shape)}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return gemm_plain(a, b)
    (m, k), n = a.shape, b.shape[1]
    tm, tn, tk = TILE[a.dtype]
    if m % tm or n % tn or k % tk or not (m and n and k):
        raise ValueError(f"gemm: the kernel takes M % {tm}, N % {tn} and K % {tk} == 0 "
                         f"for {a.dtype}, got {m}x{k}x{n}")
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"gemm: unsupported devices {a.device}, {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("gemm: operands must be contiguous row-major")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("gemm: operands must start on 16 bytes (TMA)")
    code_dt, out_dt = _DTYPES[a.dtype]
    c = torch.empty((m, n), dtype=out_dt, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    code = _lib()(code_dt, a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, stream)
    _build.check(code, "gemm_probe")
    gemm.launches += 1
    return c


gemm.launches = 0
