"""FlowOccNetC, eager (port of
``ocflow_tpu/models/flow_occ_nets.py:FlowOccNetC``): the FlowNetC trunk
(d=10 cost volume on the hand-written kernel for CUDA tensors) and dual
heads per level, in the order ``PredictFlow``, ``PredictOcc``, flow
up-deconv, occlusion up-deconv, feature deconv; each level reads
``cat([skip, deconv, flow_up, occ_up])``. Parameter names are the
reference's (``predict_flow6``, ``predict_occ6.0``,
``upsampled_flow6_to_5``, ``upsampled_occ6_to_5``, ``deconv5.0``, ...),
which ``convert_flow_occ_net_c`` of the JAX package maps onto its flax
tree.
"""

from __future__ import annotations

from ocflow_torch.models.flow_net_s import FlowNetCFamily


class FlowOccNetC(FlowNetCFamily):
    """``(flow [B, H, W, 2], occ [B, H, W, 1])`` from ``[B, H, W, 6]``.
    Serve it in eval mode (``model.eval()``): in train mode BatchNorm uses
    the batch's statistics (see
    :class:`~ocflow_torch.models.flow_net_s.FlowNetCFamily`)."""

    HEADS = ("flow", "occ")
