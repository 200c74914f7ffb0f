"""AI Challenger 14-keypoint metainfo (dataset constants).

Factual dataset metadata (keypoint names and order, left-right symmetry,
skeleton links, OKS sigmas and joint loss weights) matching the reference
metainfo file ``configs/_base_/datasets/aic.py``.
"""

_RED, _GREEN, _BLUE = [255, 128, 0], [0, 255, 0], [51, 153, 255]

# (name, colour, type, swap)
_KEYPOINTS = [
    ("right_shoulder", _RED, "upper", "left_shoulder"),
    ("right_elbow", _RED, "upper", "left_elbow"),
    ("right_wrist", _RED, "upper", "left_wrist"),
    ("left_shoulder", _GREEN, "upper", "right_shoulder"),
    ("left_elbow", _GREEN, "upper", "right_elbow"),
    ("left_wrist", _GREEN, "upper", "right_wrist"),
    ("right_hip", _RED, "lower", "left_hip"),
    ("right_knee", _RED, "lower", "left_knee"),
    ("right_ankle", _RED, "lower", "left_ankle"),
    ("left_hip", _GREEN, "lower", "right_hip"),
    ("left_knee", _GREEN, "lower", "right_knee"),
    ("left_ankle", _GREEN, "lower", "right_ankle"),
    ("head_top", _BLUE, "upper", ""),
    ("neck", _BLUE, "upper", ""),
]
_SKELETON = [
    (("right_wrist", "right_elbow"), _RED),
    (("right_elbow", "right_shoulder"), _RED),
    (("right_shoulder", "neck"), _BLUE),
    (("neck", "left_shoulder"), _BLUE),
    (("left_shoulder", "left_elbow"), _GREEN),
    (("left_elbow", "left_wrist"), _GREEN),
    (("right_ankle", "right_knee"), _RED),
    (("right_knee", "right_hip"), _RED),
    (("right_hip", "left_hip"), _BLUE),
    (("left_hip", "left_knee"), _GREEN),
    (("left_knee", "left_ankle"), _GREEN),
    (("head_top", "neck"), _BLUE),
    (("right_shoulder", "right_hip"), _BLUE),
    (("left_shoulder", "left_hip"), _BLUE),
]

AIC_METAINFO = dict(
    dataset_name="aic",
    keypoint_info={i: dict(name=n, id=i, color=c, type=t, swap=s) for i, (n, c, t, s) in enumerate(_KEYPOINTS)},
    skeleton_info={i: dict(link=link, id=i, color=c) for i, (link, c) in enumerate(_SKELETON)},
    joint_weights=[1.0, 1.2, 1.5, 1.0, 1.2, 1.5, 1.0, 1.2, 1.5, 1.0, 1.2, 1.5, 1.0, 1.0],
    sigmas=[
        0.01388152, 0.01515228, 0.01057665, 0.01417709, 0.01497891, 0.01402144, 0.03909642,
        0.03686941, 0.01981803, 0.03843971, 0.03412318, 0.02415081, 0.01291456, 0.01236173,
    ],
)
