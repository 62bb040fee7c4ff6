"""OcclusionNetC, eager (port of
``ocflow_tpu/models/occlusion_nets.py:OcclusionNetC``): the FlowNetC trunk
(d=10 cost volume on the hand-written kernel for CUDA tensors) and
``PredictOcc`` heads with 1-channel up-deconvs. Parameter names are the
reference's (``predict_occ6.0``, ``upsampled_occ6_to_5``, ``deconv5.0``,
...), which ``convert_occlusion_net_c`` of the JAX package maps onto its
flax tree.
"""

from __future__ import annotations

from ocflow_torch.models.flow_net_s import FlowNetCFamily


class OcclusionNetC(FlowNetCFamily):
    """Occlusion probability ``[B, H, W, 1]`` in [0, 1] (1 = occluded) from
    ``[B, H, W, 6]``. Serve it in eval mode (``model.eval()``): in train
    mode BatchNorm uses the batch's statistics (see
    :class:`~ocflow_torch.models.flow_net_s.FlowNetCFamily`)."""

    HEADS = ("occ",)
