"""The port's models: FlowNetCV / PWCNet (eager), their fused serving path
and weight bridge; the FlowNetC family (FlowNetC, OcclusionNetC,
FlowOccNetC; serve them in eval mode) and its weight bridges; the registry
``build``."""

from ocflow_torch.models.convert import (flownetc_from_flax, flownetcv_from_flax,
                                         flowoccnetc_from_flax, occnetc_from_flax,
                                         q8_scales_from_numpy)
from ocflow_torch.models.flow_net_s import FlowNetC, FlowNetCFamily
from ocflow_torch.models.flow_occ_nets import FlowOccNetC
from ocflow_torch.models.occlusion_nets import OcclusionNetC
from ocflow_torch.models.pwc_fast import calibrate_q8, fast_apply, fast_apply_pair, prepare
from ocflow_torch.models.pwc_net import FlowNetCV, PWCNet
from ocflow_torch.models.registry import available, build

__all__ = ["FlowNetC", "FlowNetCFamily", "FlowNetCV", "FlowOccNetC", "OcclusionNetC",
           "PWCNet", "available", "build", "calibrate_q8", "fast_apply", "fast_apply_pair",
           "flownetc_from_flax", "flownetcv_from_flax", "flowoccnetc_from_flax",
           "occnetc_from_flax", "prepare", "q8_scales_from_numpy"]
