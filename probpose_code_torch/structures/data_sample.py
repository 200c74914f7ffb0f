"""Data containers: InstanceData and PoseDataSample.

A minimal own copy of ``probpose_code_tpu/structures/data_sample.py``: numpy
attribute dicts with a separate metainfo namespace and the reference field
names (``pred_instances.keypoints``, ``keypoint_scores``, ``keypoints_probs``,
``keypoints_visible``, ``keypoints_oks``, ``keypoints_error``), so code that
reads the JAX package's samples reads these too.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class ElementData:
    """Attribute dict with a separate metainfo namespace."""

    def __init__(self, metainfo: Optional[Dict[str, Any]] = None, **fields):
        object.__setattr__(self, "_metainfo", dict(metainfo or {}))
        object.__setattr__(self, "_fields", {})
        for k, v in fields.items():
            setattr(self, k, v)

    @property
    def metainfo(self) -> Dict[str, Any]:
        return self._metainfo

    def set_metainfo(self, metainfo: Dict[str, Any]) -> None:
        self._metainfo.update(metainfo)

    def __getattr__(self, name: str) -> Any:
        fields = object.__getattribute__(self, "_fields")
        if name in fields:
            return fields[name]
        meta = object.__getattribute__(self, "_metainfo")
        if name in meta:
            return meta[name]
        raise AttributeError(f"{type(self).__name__} has no field '{name}'")

    def __setattr__(self, name: str, value: Any) -> None:
        if name.startswith("_"):
            object.__setattr__(self, name, value)
        else:
            self._fields[name] = value

    def __contains__(self, name: str) -> bool:
        return name in self._fields or name in self._metainfo

    def __getitem__(self, name: str):
        return getattr(self, name)

    def get(self, name: str, default: Any = None) -> Any:
        try:
            return getattr(self, name)
        except AttributeError:
            return default

    def set_field(self, value: Any, name: str) -> None:
        setattr(self, name, value)

    def keys(self):
        return self._fields.keys()

    def items(self):
        return self._fields.items()


class InstanceData(ElementData):
    """Per-instance fields; the first dim of every array is the instance."""


class PoseDataSample(ElementData):
    """Per-sample contract: ``gt_instances`` and ``pred_instances`` plus
    free-form metainfo (img_shape, input_size, input_center, input_scale,
    flip_indices, id, img_id, ...)."""

    @property
    def gt_instances(self) -> InstanceData:
        return self._fields.setdefault("gt_instances", InstanceData())

    @gt_instances.setter
    def gt_instances(self, value: InstanceData) -> None:
        self._fields["gt_instances"] = value

    @property
    def pred_instances(self) -> InstanceData:
        return self._fields.setdefault("pred_instances", InstanceData())

    @pred_instances.setter
    def pred_instances(self, value: InstanceData) -> None:
        self._fields["pred_instances"] = value
