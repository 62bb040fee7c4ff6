"""FlowNetCV / PWCNet (eager), their fused serving path and weight bridge."""

from ocflow_torch.models.convert import flownetcv_from_flax, q8_scales_from_numpy
from ocflow_torch.models.pwc_fast import calibrate_q8, fast_apply, fast_apply_pair, prepare
from ocflow_torch.models.pwc_net import FlowNetCV, PWCNet

__all__ = ["FlowNetCV", "PWCNet", "calibrate_q8", "fast_apply", "fast_apply_pair",
           "flownetcv_from_flax", "prepare", "q8_scales_from_numpy"]
