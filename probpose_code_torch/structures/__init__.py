"""Data contracts and bbox geometry."""

from .data_sample import InstanceData, PoseDataSample  # noqa: F401
