"""Data (port of ``ocflow_tpu/data``): the procedural datasets and the
loaders, the device-resident cache among them."""

from ocflow_torch.data.datasets import (DATASET_REGISTRY, Dataset, SyntheticFlow,
                                        SyntheticFlowWarp, gaussian_blur, remap_bilinear)
from ocflow_torch.data.pipeline import (CacheDataset, DataLoader, DeviceCacheLoader,
                                        Subset, build_dataset, device_iterator, prefetch,
                                        random_split)

__all__ = ["DATASET_REGISTRY", "CacheDataset", "DataLoader", "Dataset", "DeviceCacheLoader",
           "Subset", "SyntheticFlow", "SyntheticFlowWarp", "build_dataset",
           "device_iterator", "gaussian_blur", "prefetch", "random_split", "remap_bilinear"]
