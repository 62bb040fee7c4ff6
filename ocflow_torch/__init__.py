"""PyTorch / CUDA port of ``ocflow_tpu`` for one NVIDIA H100.

The JAX package ``ocflow_tpu`` is the reference; this package computes the
same functions with plain PyTorch and with kernels written by hand for
Hopper (``csrc/``). It never imports ``jax`` or ``ocflow_tpu``.

Covered so far: the FlowNetCV serving forward (``models.pwc_fast.fast_apply``)
in bf16, fp32 and W8A8 (``calibrate_q8``) with its ops (cost volume,
feature normalization, warp, resize), the eager ``FlowNetCV`` / ``PWCNet``
modules, the weight and W8A8-scale bridges from the JAX package
(``models.convert``); the occlusion-aware unsupervised training step
(``train``: ``make_unsupervised_flow_step``, ``TrainState`` with Adam, the
config) over the gradient-carrying pair ``fast_apply_pair`` (the
differentiable cost volume with its backward kernel, ``conv_group_diff``),
the losses (``losses``: photometric, census, smoothness, BCE) and the
range map and occlusion masks (``ops.range_map``); the training system
around the step (``python -m ocflow_torch.train_unsupervised``: the
procedural datasets and loaders with the device cache, ``data``; the fit
loop, ``train.loop``; checkpoints, panels and the PNG writer, ``utils``;
flow metrics, ``metrics``); data parallelism over several processes
(``parallel``: the process group, the data mesh, the rank-wide metrics, the
height-sharded cost volume and warp); and measurement tools (``tools``: the
int8 / bf16 GEMM probe, W8A8 accuracy, the training step's profile, the
W8A8 arms' EPE on trained weights, the multi-rank dry run).

Layout: the public model entry points take and return NHWC like the JAX
package; everything inside (ops, kernels, modules) is NCHW.
"""

import contextlib

import torch


@contextlib.contextmanager
def full_fp32_convs(dtype: torch.dtype):
    """Inside, for ``dtype`` fp32, cuDNN convolutions and CUDA matmuls run in
    full fp32 (TF32 off), as the eager reference they are held to; other
    dtypes are left alone. PyTorch's default lets cuDNN round fp32
    convolutions to TF32, which moved the fp32 ``fast_apply`` at 8x448x1024
    to 1.06e-4 of max|flow| on an H100, over the port's 1e-4; its default
    for matmuls is full fp32 already, and stays pinned here (the bilinear
    resize is two matmuls)."""
    if dtype != torch.float32:
        yield
        return
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. Raises when CUDA is wanted but absent (no silent CPU
    fallback)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
