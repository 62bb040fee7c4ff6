"""FlowNetCV / PWCNet (eager), their fused serving path and weight bridge."""

from ocflow_torch.models.convert import flownetcv_from_flax
from ocflow_torch.models.pwc_fast import fast_apply, prepare
from ocflow_torch.models.pwc_net import FlowNetCV, PWCNet

__all__ = ["FlowNetCV", "PWCNet", "fast_apply", "flownetcv_from_flax", "prepare"]
