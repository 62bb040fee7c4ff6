"""Occlusion nets, eager (port of ``ocflow_tpu/models/occlusion_nets.py``):
each ``[B, H, W, 6]`` -> the occlusion probability ``[B, H, W, 1]`` in
[0, 1] (1 = occluded).

- ``SimpleOcclusionNet`` (``occ/simple``): SimpleFlowNet's U-Net with a
  ``PredictOccStack`` head per level (``predict_occ5`` ... ``predict_occ0``,
  a sigmoid each), whose output is fed back into the decoder;
- ``OcclusionNetS`` (``occ/occnets``): the FlowNetS trunk and decoder with
  ``PredictOcc`` heads and 1-channel up-deconvs;
- ``OcclusionNetC`` (``occ/occnetc``): the same decoder on the FlowNetC
  trunk, whose d=10 cost volume runs the hand-written kernel for CUDA
  tensors. The other two launch no kernel of this repository.

All three have BatchNorm: serve them in eval mode. Parameter names are the
reference torch networks' (``down1.conv1`` ..., ``predict_occ5.0.0``;
``conv1.0`` ..., ``predict_occ6.0``, ``upsampled_occ6_to_5``,
``deconv5.0``), which ``convert_simple_occlusion_net``,
``convert_occlusion_net_s`` and ``convert_occlusion_net_c`` of the JAX
package map onto its flax trees (OcclusionNetS's up-deconv biases aside:
:class:`~ocflow_torch.models.flow_net_s.FlowNetSFamily`).
"""

from __future__ import annotations

from torch import nn

from ocflow_torch.models.common import PredictOccStack
from ocflow_torch.models.flow_net_s import FlowNetCFamily, FlowNetSFamily
from ocflow_torch.models.simple_flow_net import SimpleFlowNet


class SimpleOcclusionNet(SimpleFlowNet):
    """SimpleFlowNet's U-Net with occlusion heads (``ocflow_tpu/models/
    occlusion_nets.py:SimpleOcclusionNet``): the occlusion ``[B, H, W, 1]``
    from ``[B, H, W, 6]`` (H and W divisible by 32)."""

    HEAD = "occ"

    def __init__(self, in_channels: int = 6, generator=None):
        super().__init__(in_channels, 1, generator)

    def _head(self, cin: int, cout: int) -> nn.Module:
        return PredictOccStack(cin)


class OcclusionNetS(FlowNetSFamily):
    """The FlowNetS trunk with occlusion heads (``ocflow_tpu/models/
    occlusion_nets.py:OcclusionNetS``)."""

    HEADS = ("occ",)


class OcclusionNetC(FlowNetCFamily):
    """Occlusion probability ``[B, H, W, 1]`` in [0, 1] (1 = occluded) from
    ``[B, H, W, 6]``. Serve it in eval mode (``model.eval()``): in train
    mode BatchNorm uses the batch's statistics (see
    :class:`~ocflow_torch.models.flow_net_s.FlowNetCFamily`)."""

    HEADS = ("occ",)
