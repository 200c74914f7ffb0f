"""PackPoseInputs: bundle pipeline results into (inputs, PoseDataSample).

The port's own ``PackPoseInputs`` (``probpose_code_tpu/datasets/transforms/
formatting.py:23``, reference ``datasets/transforms/formatting.py:61``), with
the ProbPose instance keys, the training labels (``gt_instance_labels``
through the label table, ``:110-117``) and the device passthrough
(``:136``): a sample from ``TopdownAffine``'s canvas form carries ``canvas``
and ``warp_mat`` instead of a crop, one from its JPEG form ``img_bytes``,
``jpeg_info`` and ``warp_mat``, and one from ``GenerateTarget`` the
heatmap-space keypoints instead of maps (DoubleProbMap's in both windows)
and the bbox mask's rectangle and matrix instead of the mask. Images stay
NumPy; the loader's collate batches them. The JAX transform's ``gt_fields`` hold host-encoded
maps, which the port never makes.
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

    label_mapping_table = dict(
        keypoint_labels="keypoint_labels",
        keypoint_x_labels="keypoint_x_labels",
        keypoint_y_labels="keypoint_y_labels",
        keypoint_weights="keypoint_weights",
        keypoints_visible_weights="keypoints_visible_weights",
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
        if "in_image" in results:
            results["keypoints_in_image"] = (np.asarray(results.get("keypoints_in_image", results["in_image"]))
                                             .astype(bool) & np.asarray(results["in_image"]).astype(bool))

        data_sample = PoseDataSample()
        gt_instances = InstanceData()
        for key, packed_key in results.get("instance_mapping_table", self.instance_mapping_table).items():
            if key in results:
                gt_instances.set_field(results[key], packed_key)
        data_sample.gt_instances = gt_instances

        gt_instance_labels = InstanceData()
        for key, packed_key in results.get("label_mapping_table", self.label_mapping_table).items():
            if key in results:
                value = results[key]
                gt_instance_labels.set_field(np.asarray(np.stack(value) if isinstance(value, list) else value),
                                             packed_key)
        data_sample.gt_instance_labels = gt_instance_labels
        data_sample.set_metainfo({k: results[k] for k in self.meta_keys if k in results})

        packed = dict(inputs=inputs, data_samples=data_sample)
        # device passthrough: the canvas (or the JPEG file and its header) and
        # its geometry instead of a crop, the heatmap-space keypoints instead
        # of target maps
        for key in ("canvas", "img_bytes", "jpeg_info", "warp_mat", "device_kpts_hm", "device_kpts_hm_out",
                    "device_kpts_visible", "bbox_mask_rect", "bbox_mask_mat"):
            if key in results:
                packed[key] = results[key]
        return packed
