"""OCFlowNet, eager (port of ``ocflow_tpu/models/ocflownet.py``): the
end-to-end composition flow -> warp -> hard occlusion mask -> scene
completion.

``forward(x)`` takes ``[B, H, W, 6]`` (frames 1 | 2 on channels, H and W
divisible by 64) and returns ``(flow [B, H, W, 2], occ [B, H, W, 1],
completed [B, H, W, 3])``: ``SimpleFlowOccNet`` (``flow_occ``) gives the
flow and the straight-through hard occlusion, frame 2 is backward-warped by
the flow (``align_corners=True``), and ``InpaintingNet`` (``inpaint``)
completes the warped frame under the mask. No kernel of this repository
runs; both nets carry BatchNorm, so serve it in eval mode.
"""

from __future__ import annotations

import torch
from torch import nn

from ocflow_torch.models.common import init_weights
from ocflow_torch.models.flow_occ_nets import SimpleFlowOccNet
from ocflow_torch.models.inpainting_net import InpaintingNet
from ocflow_torch.ops.warp import warp


class OCFlowNet(nn.Module):
    """See the module docstring. ``generator`` seeds the init of both nets
    (flow+occlusion first, as the flax module creates them)."""

    def __init__(self, generator: torch.Generator | None = None):
        super().__init__()
        self.flow_occ = SimpleFlowOccNet()
        self.inpaint = InpaintingNet()
        if generator is not None:
            init_weights(self, generator)

    def forward(self, x: torch.Tensor):
        flow, occ = self.flow_occ(x)
        img2 = x[..., 3:].permute(0, 3, 1, 2)
        warped = warp(img2, flow.permute(0, 3, 1, 2), align_corners=True)
        completed = self.inpaint(warped.permute(0, 2, 3, 1), occ)
        return flow, occ, completed
