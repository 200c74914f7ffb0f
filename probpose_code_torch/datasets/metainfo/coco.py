"""COCO 17-keypoint metainfo (dataset constants).

Factual dataset metadata (keypoint names/order, left-right symmetry,
skeleton links, standard COCO OKS sigmas and joint loss weights) matching
the reference metainfo file ``configs/_base_/datasets/coco.py``.
"""

_KPT_NAMES = [
    "nose", "left_eye", "right_eye", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip",
    "left_knee", "right_knee", "left_ankle", "right_ankle",
]

_BLUE = [51, 153, 255]
_GREEN = [0, 255, 0]
_ORANGE = [255, 128, 0]

_KPT_COLORS = [_BLUE] * 5 + [_GREEN, _ORANGE] * 3 + [_GREEN, _ORANGE] * 3
_KPT_TYPES = ["upper"] * 11 + ["lower"] * 6


def _swap_name(name: str) -> str:
    if name.startswith("left_"):
        return "right_" + name[5:]
    if name.startswith("right_"):
        return "left_" + name[6:]
    return ""


_SKELETON = [
    (("left_ankle", "left_knee"), _GREEN),
    (("left_knee", "left_hip"), _GREEN),
    (("right_ankle", "right_knee"), _ORANGE),
    (("right_knee", "right_hip"), _ORANGE),
    (("left_hip", "right_hip"), _BLUE),
    (("left_shoulder", "left_hip"), _BLUE),
    (("right_shoulder", "right_hip"), _BLUE),
    (("left_shoulder", "right_shoulder"), _BLUE),
    (("left_shoulder", "left_elbow"), _GREEN),
    (("right_shoulder", "right_elbow"), _ORANGE),
    (("left_elbow", "left_wrist"), _GREEN),
    (("right_elbow", "right_wrist"), _ORANGE),
    (("left_eye", "right_eye"), _BLUE),
    (("nose", "left_eye"), _BLUE),
    (("nose", "right_eye"), _BLUE),
    (("left_eye", "left_ear"), _BLUE),
    (("right_eye", "right_ear"), _BLUE),
    (("left_ear", "left_shoulder"), _BLUE),
    (("right_ear", "right_shoulder"), _BLUE),
]

COCO_SIGMAS = [
    0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072, 0.072,
    0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089, 0.089,
]

COCO_JOINT_WEIGHTS = [
    1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.2, 1.2, 1.5, 1.5,
    1.0, 1.0, 1.2, 1.2, 1.5, 1.5,
]

COCO_METAINFO = dict(
    dataset_name="coco",
    keypoint_info={
        i: dict(name=n, id=i, color=_KPT_COLORS[i], type=_KPT_TYPES[i], swap=_swap_name(n))
        for i, n in enumerate(_KPT_NAMES)
    },
    skeleton_info={
        i: dict(link=link, id=i, color=color) for i, (link, color) in enumerate(_SKELETON)
    },
    joint_weights=COCO_JOINT_WEIGHTS,
    sigmas=COCO_SIGMAS,
)
