"""Dataset meta-information: keypoint definitions, flip pairs, OKS sigmas.

The port's own copy of ``probpose_code_tpu/datasets/metainfo`` for COCO:
``parse_pose_metainfo`` (``__init__.py:65``) over the COCO table.
"""

from __future__ import annotations

import numpy as np

from .coco import COCO_METAINFO

DATASET_METAINFO = {"coco": COCO_METAINFO}


def parse_pose_metainfo(metainfo: dict) -> dict:
    """Normalize raw dataset metainfo into the parsed form.

    Accepts ``{"dataset_name": <registered name>}`` or a full raw metainfo
    dict with keypoint_info/skeleton_info/joint_weights/sigmas.
    """
    if set(metainfo.keys()) == {"dataset_name"}:
        name = metainfo["dataset_name"]
        if name not in DATASET_METAINFO:
            raise KeyError(f"no metainfo table for dataset '{name}'")
        metainfo = DATASET_METAINFO[name]

    for key in ("dataset_name", "keypoint_info", "skeleton_info", "joint_weights", "sigmas"):
        if key not in metainfo:
            raise KeyError(f"metainfo missing required key {key}")

    parsed: dict = dict(
        dataset_name=metainfo["dataset_name"],
        num_keypoints=len(metainfo["keypoint_info"]),
        keypoint_id2name={},
        keypoint_name2id={},
        upper_body_ids=[],
        lower_body_ids=[],
        flip_indices=[],
        flip_pairs=[],
        keypoint_colors=[],
        num_skeleton_links=len(metainfo["skeleton_info"]),
        skeleton_links=[],
        skeleton_link_colors=[],
    )

    for kpt_id, kpt in metainfo["keypoint_info"].items():
        name = kpt["name"]
        parsed["keypoint_id2name"][kpt_id] = name
        parsed["keypoint_name2id"][name] = kpt_id
        parsed["keypoint_colors"].append(kpt.get("color", [255, 128, 0]))
        kpt_type = kpt.get("type", "")
        if kpt_type == "upper":
            parsed["upper_body_ids"].append(kpt_id)
        elif kpt_type == "lower":
            parsed["lower_body_ids"].append(kpt_id)
        swap = kpt.get("swap", "")
        if swap in ("", name):
            parsed["flip_indices"].append(name)
        else:
            parsed["flip_indices"].append(swap)
            pair = (swap, name)
            if pair not in parsed["flip_pairs"]:
                parsed["flip_pairs"].append(pair)

    for _, sk in metainfo["skeleton_info"].items():
        parsed["skeleton_links"].append(sk["link"])
        parsed["skeleton_link_colors"].append(sk.get("color", [96, 96, 255]))

    parsed["dataset_keypoint_weights"] = np.array(metainfo["joint_weights"], dtype=np.float32)
    parsed["sigmas"] = np.array(metainfo["sigmas"], dtype=np.float32)

    name2id = parsed["keypoint_name2id"]
    parsed["flip_pairs"] = [(name2id[a], name2id[b]) for a, b in parsed["flip_pairs"]]
    parsed["flip_indices"] = [name2id[n] for n in parsed["flip_indices"]]
    parsed["skeleton_links"] = [(name2id[a], name2id[b]) for a, b in parsed["skeleton_links"]]
    parsed["keypoint_colors"] = np.array(parsed["keypoint_colors"], dtype=np.uint8)
    parsed["skeleton_link_colors"] = np.array(parsed["skeleton_link_colors"], dtype=np.uint8)
    return parsed
