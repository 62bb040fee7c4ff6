"""The joint step of the port (``train.steps_joint``) in fp32 against the
JAX package's, on the CPU with the weights and batches of
``tests/test_torch_joint_step.py`` (whose fp64 test holds the two packages
to 1e-4 per gradient tensor; read 9e-8). The port's own fp64 step is the
witness of the reading here; the bf16 step is
``tests/test_torch_joint_step_bf16.py``. One JAX step (jitted) and one fp64
port step per run.

At 2x64x64: the loss and every metric within 1e-5 relative of the JAX
package's fp32 step; each gradient tensor within ``FP32_GRAD_REL`` of its
net's max|grad| of the fp64 gradient (read 2.3e-4 in FlowOccNetCV, 3.5e-4
in InpaintingNet). The JAX package's own fp32 gradient lies 2.1e-2 and
1.6e-2 from it (printed), so the two fp32 steps are held on the whole only
within ``FP32_GRAD_L2`` (relative L2, read 1.6e-2): InpaintingNet's deepest
train-mode BatchNorms normalize 2 values a channel, and the reconstruction
term carries their rounding into both nets (without it the port's fp32
FlowOccNetCV gradient reads 4e-7 from fp64).
"""

import numpy as np

from test_torch_joint_step import _part, port_grads, run
from test_torch_ops import share_cores  # noqa: F401  (autouse)
from test_torch_two_stage_step import whole_l2

METRIC_REL, FP32_GRAD_REL, FP32_GRAD_L2 = 1e-5, 1e-3, 5e-2


def _per_tensor(got, want):
    """max over tensors of max|got - want| over the net's max|want|."""
    scale = max(np.abs(w).max() for w in want.values())
    return max(np.abs(got[k] - w).max() for k, w in want.items()) / scale


def test_joint_step_fp32_matches_jax():
    (m32, g32, _), (jm32, jg32, _), _, _, _ = run("fp32")
    g64 = port_grads("fp64")
    rel = max(abs(m32[k] - v) / abs(v) for k, v in jm32.items())
    l2 = whole_l2(g32, jg32)
    per = {n: (_per_tensor(_part(g32, n), _part(g64, n)),
               _per_tensor(_part(jg32, n), _part(g64, n))) for n in ("flow_occ", "inpaint")}
    print(f"fp32: metrics relative {rel:.3e}; gradient whole {l2:.3e}; per tensor of the net's "
          f"max|grad| from the fp64 gradient (port, JAX) {per}")
    assert rel <= METRIC_REL and l2 <= FP32_GRAD_L2
    assert all(p <= FP32_GRAD_REL for p, _ in per.values()), per
