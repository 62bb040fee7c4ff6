"""Plain PyTorch ops of the FlowNetCV path (NCHW)."""

from ocflow_torch.ops.cost_volume import cost_volume, normalize_features
from ocflow_torch.ops.resize import resize_bilinear
from ocflow_torch.ops.warp import flow_to_warp, mesh_grid, warp

__all__ = [
    "cost_volume", "flow_to_warp", "mesh_grid", "normalize_features",
    "resize_bilinear", "warp",
]
