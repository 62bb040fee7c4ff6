"""Metrics (port of ``ocflow_tpu/metrics``): flow EPE, KITTI outliers and
occlusion F1."""

from ocflow_torch.metrics.flow_metrics import (calculate_average_epe, evaluate_flow,
                                               evaluate_kitti_flow, flow_error,
                                               flow_kitti_error, occlusion_f1)

__all__ = ["calculate_average_epe", "evaluate_flow", "evaluate_kitti_flow", "flow_error",
           "flow_kitti_error", "occlusion_f1"]
