"""PyTorch / CUDA port of ``ocflow_tpu`` for one NVIDIA H100.

The JAX package ``ocflow_tpu`` is the reference; this package computes the
same functions with plain PyTorch and with kernels written by hand for
Hopper (``csrc/``). It never imports ``jax`` or ``ocflow_tpu``.

Covered so far: the FlowNetCV serving forward (``models.pwc_fast.fast_apply``)
in bf16, fp32 and W8A8 (``calibrate_q8``) with its ops (cost volume,
feature normalization, warp, resize), the eager ``FlowNetCV`` / ``PWCNet``
modules, the weight and W8A8-scale bridges from the JAX package
(``models.convert``), and measurement tools (``tools``: the int8 / bf16
GEMM probe, W8A8 accuracy).

Layout: the public model entry points take and return NHWC like the JAX
package; everything inside (ops, kernels, modules) is NCHW.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. Raises when CUDA is wanted but absent (no silent CPU
    fallback)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
