"""Plain PyTorch ops of the FlowNetCV path (NCHW)."""

from ocflow_torch.ops.cost_volume import cost_volume, normalize_features
from ocflow_torch.ops.range_map import (compute_range_map, occlusion_fb_consistency,
                                        occlusion_from_back_flow)
from ocflow_torch.ops.resize import resize_bilinear
from ocflow_torch.ops.warp import flow_to_warp, mesh_grid, warp

__all__ = [
    "compute_range_map", "cost_volume", "flow_to_warp", "mesh_grid",
    "normalize_features", "occlusion_fb_consistency",
    "occlusion_from_back_flow", "resize_bilinear", "warp",
]
