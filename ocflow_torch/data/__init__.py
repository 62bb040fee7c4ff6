"""Data (port of ``ocflow_tpu/data``): the procedural and the file-backed
flow datasets, their IO (``.flo``, KITTI PNG, PFM, PNG and PPM frames on
the port's own host decoder) and the loaders, the device-resident cache
among them."""

from ocflow_torch.data.datasets import (DATASET_REGISTRY, FILE_DATASETS, Dataset,
                                        SyntheticFlow, SyntheticFlowWarp, gaussian_blur,
                                        remap_bilinear)
from ocflow_torch.data.flow_io import (read_flo, read_kitti_png_flow, read_pfm,
                                       resize_flow_np, write_flo, write_kitti_png_flow)
from ocflow_torch.data.frame_io import read_gen
from ocflow_torch.data.pipeline import (CacheDataset, DataLoader, DeviceCacheLoader,
                                        Subset, build_dataset, device_iterator, prefetch,
                                        random_split)

__all__ = ["DATASET_REGISTRY", "FILE_DATASETS", "CacheDataset", "DataLoader", "Dataset",
           "DeviceCacheLoader", "Subset", "SyntheticFlow", "SyntheticFlowWarp",
           "build_dataset", "device_iterator", "gaussian_blur", "prefetch", "random_split",
           "read_flo", "read_gen", "read_kitti_png_flow", "read_pfm", "remap_bilinear",
           "resize_flow_np", "write_flo", "write_kitti_png_flow"]
