"""Dataset meta-information: keypoint definitions, flip pairs, OKS sigmas.

The port's own copy of ``probpose_code_tpu/datasets/metainfo`` for COCO,
CropCOCO (``coco_crop.py``: COCO's table under another name), AI
Challenger (``data/aic.json``), the other body datasets of the body8
recipes (``body.py``, ``halpe.py``: ``data/<name>.json``) and
COCO-WholeBody and UBody-2D (``wholebody.py``) and the face and hand
datasets (``face.py``, ``hand.py``; the cocktail14 recipe's Human-Art-21 and
InterHand2.6M in ``body.py`` and ``hand.py``), the animal and fashion datasets
(``animal.py``, ``fashion.py``) and ExLPose (``body.py``):
``parse_pose_metainfo`` (``__init__.py:65``) over those tables.
"""

from __future__ import annotations

import numpy as np

from . import animal, body, face, fashion, hand
from .aic import AIC_METAINFO
from .coco import COCO_METAINFO
from .halpe import HALPE
from .wholebody import COCO_WHOLEBODY, UBODY2D

DATASET_METAINFO = {"coco": COCO_METAINFO, "coco_crop": {**COCO_METAINFO, "dataset_name": "coco_crop"},
                    "aic": AIC_METAINFO, "crowdpose": body.CROWDPOSE, "mpii": body.MPII, "jhmdb": body.JHMDB,
                    "posetrack18": body.POSETRACK18, "ochuman": body.OCHUMAN, "humanart": body.HUMANART,
                    "humanart21": body.HUMANART21, "interhand2d": hand.INTERHAND2D,
                    "halpe": HALPE, "halpe26": body.HALPE26,
                    "coco_wholebody": COCO_WHOLEBODY, "ubody2d": UBODY2D,
                    "300w": face.FACE_300W, "300wlp": face.FACE_300WLP, "wflw": face.WFLW, "cofw": face.COFW,
                    "aflw": face.AFLW, "lapa": face.LAPA, "coco_wholebody_face": face.COCO_WHOLEBODY_FACE,
                    "onehand10k": hand.ONEHAND10K, "freihand2d": hand.FREIHAND2D, "rhd2d": hand.RHD2D,
                    "panoptic_hand2d": hand.PANOPTIC_HAND2D, "coco_wholebody_hand": hand.COCO_WHOLEBODY_HAND,
                    "ap10k": animal.AP10K, "animalpose": animal.ANIMALPOSE, "horse10": animal.HORSE10,
                    "macaque": animal.MACAQUE, "fly": animal.FLY, "locust": animal.LOCUST, "zebra": animal.ZEBRA,
                    "atrw": animal.ATRW, "ak": animal.AK, "deepfashion_full": fashion.DEEPFASHION_FULL,
                    "deepfashion_upper": fashion.DEEPFASHION_UPPER, "deepfashion_lower": fashion.DEEPFASHION_LOWER,
                    "deepfashion2": fashion.DEEPFASHION2, "exlpose": body.EXLPOSE}


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
