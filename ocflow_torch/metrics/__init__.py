"""Metrics (port of ``ocflow_tpu/metrics``): flow EPE, KITTI outliers and
occlusion F1; PSNR and SSIM of inpainted images, and their means over
batches."""

from ocflow_torch.metrics.flow_metrics import (calculate_average_epe, evaluate_flow,
                                               evaluate_kitti_flow, flow_error,
                                               flow_kitti_error, occlusion_f1)
from ocflow_torch.metrics.image_metrics import (calculate_psnr, calculate_ssim,
                                                completed_images, psnr, ssim)

__all__ = ["calculate_average_epe", "calculate_psnr", "calculate_ssim", "completed_images",
           "evaluate_flow", "evaluate_kitti_flow", "flow_error", "flow_kitti_error",
           "occlusion_f1", "psnr", "ssim"]
