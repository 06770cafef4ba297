from animate_anything_tpu_torch.data.bucketing import sensible_buckets
from animate_anything_tpu_torch.data.datasets import (CachedDataset, ConcatDataset, FolderDataset,
                                                      ImageDataset, SingleVideoDataset,
                                                      VideoBlipDataset, VideoJsonDataset,
                                                      extend_datasets, get_train_dataset)
from animate_anything_tpu_torch.data.loader import DataLoader, collate, device_prefetch

__all__ = [
    "CachedDataset", "ConcatDataset", "FolderDataset", "ImageDataset", "SingleVideoDataset",
    "VideoBlipDataset", "VideoJsonDataset", "extend_datasets", "get_train_dataset",
    "DataLoader", "collate", "device_prefetch", "sensible_buckets",
]
