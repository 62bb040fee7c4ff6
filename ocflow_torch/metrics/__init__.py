"""Metrics (port of ``ocflow_tpu/metrics``): flow EPE, KITTI outliers and
occlusion F1; PSNR and SSIM of inpainted images, and their means over
batches; FID and the Inception Score on InceptionV3's features."""

from ocflow_torch.metrics.flow_metrics import (calculate_average_epe, evaluate_flow,
                                               evaluate_kitti_flow, flow_error,
                                               flow_kitti_error, occlusion_f1)
from ocflow_torch.metrics.fid import (activation_statistics, calculate_fid,
                                      calculate_fid_given_imgs, frechet_distance,
                                      get_activations, inception_score)
from ocflow_torch.metrics.image_metrics import (calculate_psnr, calculate_ssim,
                                                completed_images, psnr, ssim)
from ocflow_torch.metrics.inception import InceptionV3, init_inception

__all__ = ["InceptionV3", "activation_statistics", "calculate_average_epe", "calculate_fid",
           "calculate_fid_given_imgs", "calculate_psnr", "calculate_ssim", "completed_images",
           "evaluate_flow", "evaluate_kitti_flow", "flow_error", "flow_kitti_error",
           "frechet_distance", "get_activations", "inception_score", "init_inception",
           "occlusion_f1", "psnr", "ssim"]
