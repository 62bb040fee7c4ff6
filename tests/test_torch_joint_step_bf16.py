"""The joint step of the port (``train.steps_joint``) in bf16 (``dtype:
bfloat16``, ``models.precision.apply_mixed``) against the JAX package's, on
the CPU with the weights and batches of ``tests/test_torch_joint_step.py``.
The port's own fp64 step is the witness of the reading here; the fp32 step
is ``tests/test_torch_joint_step_fp32.py``. One JAX step (jitted) and one
fp64 port step per run.

At 4x128x128 with FlowOccNetCV's last occlusion head times ``OCC_SCALE``
(seeded, ~95% of the occlusion lies within 1e-2 of 0.5, where bf16 flips
the straight-through mask; a trained net's is as clear of the threshold as
the scaled one's; ``chip_smoke.py`` scales it too): each metric within 2e-2
relative of the JAX package's bf16 step (read 3.5e-4 at worst). The
gradient, relative L2 against the JAX package's bf16 gradient, per part:
FlowOccNetCV within ``BF16_FLOW_OCC_L2`` (read 0.175; each package's bf16
gradient reads 0.16-0.18 from fp64) and InpaintingNet's last block (``up6``,
flax ``_Up_5``) within ``BF16_INPAINT_HEAD_L2`` (read 0.045; each
0.055-0.057 from fp64). The rest of InpaintingNet's bf16 gradient is
printed, not held: the bf16 cotangent grows through its train-mode
BatchNorms block by block (0.37 from fp64 at ``up5``, over 1 from ``up4``
down) in either package (whole net 1.14 and 1.09 from fp64). A zero
gradient reads 1 in every part. The master parameters and buffers stay
fp32. That bf16 steps lower the loss is held in
``tests/test_torch_joint_step.py``.
"""

import torch

from test_torch_joint_step import _part, port_grads, run
from test_torch_ops import share_cores  # noqa: F401  (autouse)
from test_torch_two_stage_step import whole_l2

BF16_METRIC_REL, BF16_FLOW_OCC_L2, BF16_INPAINT_HEAD_L2 = 2e-2, 0.25, 0.1
OCC_SCALE, BF16_SIZE = 100.0, (4, 128, 128)
BF16_PARTS = {"flow_occ": BF16_FLOW_OCC_L2, "inpaint']['_Up_5": BF16_INPAINT_HEAD_L2,
              "inpaint": None}


def test_joint_step_bf16_matches_jax():
    (m, g, _), (jm, jg, _), state, _, _ = run("bf16", OCC_SCALE, BF16_SIZE)
    g64 = port_grads("fp64", OCC_SCALE, BF16_SIZE)
    rel = {k: abs(m[k] - v) / abs(v) for k, v in jm.items() if v}
    parts = {n: (whole_l2(_part(g, n), _part(jg, n)), whole_l2(_part(g, n), _part(g64, n)),
                 whole_l2(_part(jg, n), _part(g64, n))) for n in BF16_PARTS}
    print(f"bf16: metrics relative { {k: f'{v:.3e}' for k, v in rel.items()} }; gradient "
          f"relative L2 (port vs JAX bf16, port bf16 vs fp64, JAX bf16 vs fp64) by part "
          f"{ {n: tuple(round(x, 4) for x in v) for n, v in parts.items()} }")
    assert max(rel.values()) <= BF16_METRIC_REL, rel
    for name, bound in BF16_PARTS.items():
        if bound is not None:
            assert parts[name][0] <= bound, (name, parts[name])
    assert all(v.dtype == torch.float32 for v in state.model.state_dict().values()
               if v.is_floating_point())
