"""PackPoseInputs: bundle pipeline results into (inputs, PoseDataSample).

The port's own ``PackPoseInputs`` (``probpose_code_tpu/datasets/transforms/
formatting.py:23``, reference ``datasets/transforms/formatting.py:61``), with
the ProbPose instance keys and the canvas passthrough (``:136``): a sample
from ``TopdownAffine``'s canvas form carries ``canvas`` and ``warp_mat``
instead of a crop. Images stay NumPy; the loader's
collate batches them. The label and field tables of training targets come
with ``GenerateTarget`` in the train half of the pipeline.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from probpose_code_torch.registry import TRANSFORMS
from probpose_code_torch.structures.data_sample import InstanceData, PoseDataSample


@TRANSFORMS.register_module()
class PackPoseInputs:
    instance_mapping_table = dict(
        bbox="bboxes",
        bbox_score="bbox_scores",
        keypoints="keypoints",
        keypoints_cam="keypoints_cam",
        keypoints_visible="keypoints_visible",
        keypoints_visibility="keypoints_visibility",
        bbox_scale="bbox_scales",
        head_size="head_size",
        in_image="in_image",
        keypoints_scaled="keypoints_scaled",
        heatmap_keypoints="heatmap_keypoints",
        keypoints_in_image="keypoints_in_image",
        bbox_mask="bbox_mask",
        out_heatmaps="out_heatmaps",
        out_kpt_weights="out_kpt_weights",
        bbox_xyxy_wrt_input="bbox_xyxy_wrt_input",
    )

    def __init__(
        self,
        meta_keys=(
            "id",
            "img_id",
            "img_path",
            "category_id",
            "crowd_index",
            "ori_shape",
            "img_shape",
            "input_size",
            "input_center",
            "input_scale",
            "flip",
            "flip_direction",
            "flip_indices",
            "raw_ann_info",
            "dataset_name",
            "pad_to_contain",
            "area",
        ),
    ):
        self.meta_keys = meta_keys

    def __call__(self, results: Dict) -> Optional[dict]:
        inputs = np.ascontiguousarray(results["img"]) if "img" in results else None  # HWC (BGR)

        data_sample = PoseDataSample()
        gt_instances = InstanceData()
        for key, packed_key in self.instance_mapping_table.items():
            if key in results:
                gt_instances.set_field(results[key], packed_key)
        data_sample.gt_instances = gt_instances
        data_sample.set_metainfo({k: results[k] for k in self.meta_keys if k in results})

        packed = dict(inputs=inputs, data_samples=data_sample)
        # canvas passthrough: the canvas and its geometry instead of a crop
        for key in ("canvas", "warp_mat"):
            if key in results:
                packed[key] = results[key]
        return packed
