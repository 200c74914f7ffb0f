"""Top-down COCO-style datasets, their val transforms, and the loader."""

from .base_dataset import (  # noqa: F401  (registers the datasets and transforms)
    BaseCocoStyleDataset,
    CocoCropDataset,
    CocoDataset,
    CocoWholeBodyDataset,
    CocoWholeBodyFaceDataset,
    CocoWholeBodyHandDataset,
    CombinedDataset,
    Compose,
    DeepFashionDataset,
    HalpeHandDataset,
    UBody2dDataset,
    config_metainfo,
)
from .loader import DataLoader, collate_pose_samples  # noqa: F401
