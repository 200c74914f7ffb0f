"""GetBBoxCenterScale (host-side NumPy).

The port's own copy of ``probpose_code_tpu/datasets/transforms/common.py:28``
(reference ``common_transforms.py:32``). The train transforms of that module
(``RandomFlip``, ``RandomHalfBody``, ``RandomBBoxTransform``,
``GenerateTarget``) come with the train half of the pipeline.
"""

from __future__ import annotations

from typing import Dict, Optional

from probpose_code_torch.registry import TRANSFORMS
from probpose_code_torch.structures.bbox import bbox_xyxy2cs


@TRANSFORMS.register_module()
class GetBBoxCenterScale:
    """bbox (xyxy) -> bbox_center / bbox_scale with padding; stores
    ``bbox_xyxy_wrt_input`` for the ProbPose activation-window logic."""

    def __init__(self, padding: float = 1.25):
        self.padding = padding

    def __call__(self, results: Dict) -> Optional[dict]:
        results["bbox_xyxy_wrt_input"] = results["bbox"]
        if "bbox_center" in results and "bbox_scale" in results:
            results["bbox_scale"] = results["bbox_scale"] * self.padding
        else:
            center, scale = bbox_xyxy2cs(results["bbox"], padding=self.padding)
            results["bbox_center"] = center
            results["bbox_scale"] = scale
        return results
