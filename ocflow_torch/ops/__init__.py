"""Plain PyTorch ops (NCHW; the attention on [B, tokens, channels])."""

from ocflow_torch.ops.attention import (blockwise_attention, dense_attention,
                                        spatial_self_attention)
from ocflow_torch.ops.cost_volume import cost_volume, normalize_features
from ocflow_torch.ops.range_map import (compute_range_map, occlusion_fb_consistency,
                                        occlusion_from_back_flow)
from ocflow_torch.ops.resize import resize_bilinear
from ocflow_torch.ops.warp import flow_to_warp, mesh_grid, warp

__all__ = [
    "blockwise_attention", "compute_range_map", "cost_volume", "dense_attention",
    "flow_to_warp", "mesh_grid", "normalize_features", "occlusion_fb_consistency",
    "occlusion_from_back_flow", "resize_bilinear", "spatial_self_attention", "warp",
]
