"""Metainfo of the hand datasets: OneHand10K, FreiHAND, RHD, CMU Panoptic
hand and COCO-WholeBody-Hand, 21 keypoints each (the wrist, then four of
each finger from the thumb to the little finger).

Factual dataset metadata, the port's own copy of the reference metainfo
files ``configs/_base_/datasets/<name>.py`` as the JAX package extracted
them (``probpose_code_tpu/datasets/metainfo/data/<name>.json``;
``freihand2d.json`` names its table ``freihand``). The tables pair no
keypoints for the flip and have no body types. RHD lists each finger's
keypoints from the tip down (``thumb4`` first), the others from the root
up; the skeleton is the same chain of names. Only COCO-WholeBody-Hand has
OKS sigmas.
"""

from .body import table

_WHITE, _ORANGE, _PINK, _SKY, _RED, _GREEN = ([255, 255, 255], [255, 128, 0], [255, 153, 255], [102, 178, 255],
                                              [255, 51, 51], [0, 255, 0])
_FINGERS = (("thumb", _ORANGE), ("forefinger", _PINK), ("middle_finger", _SKY), ("ring_finger", _RED),
            ("pinky_finger", _GREEN))
_SKELETON = [((f"{finger}{k}" if k else "wrist", f"{finger}{k + 1}"), colour)
             for finger, colour in _FINGERS for k in range(4)]
_SIGMAS = [0.029, 0.022, 0.035, 0.037, 0.047, 0.026, 0.025, 0.024, 0.035, 0.018, 0.024, 0.022, 0.026, 0.017, 0.021,
           0.021, 0.032, 0.02, 0.019, 0.022, 0.031]


def hand_table(name, tip_first=False, sigmas=()) -> dict:
    order = (4, 3, 2, 1) if tip_first else (1, 2, 3, 4)
    keypoints = [("wrist", _WHITE, "", "")] + [(f"{finger}{k}", colour, "", "") for finger, colour in _FINGERS
                                                 for k in order]
    return table(name, keypoints, _SKELETON, [1.0] * 21, list(sigmas))


ONEHAND10K = hand_table("onehand10k")
FREIHAND2D = hand_table("freihand")
RHD2D = hand_table("rhd2d", tip_first=True)
PANOPTIC_HAND2D = hand_table("panoptic_hand2d")
COCO_WHOLEBODY_HAND = hand_table("coco_wholebody_hand", sigmas=_SIGMAS)

# InterHand2.6M's hand (the cocktail14 recipe's InterHand2DDoubleDataset): each finger from the tip down, the
# wrist last
INTERHAND2D = table(
    "interhand2d",
    [
        ("thumb4", [255, 128, 0], "", ""),
        ("thumb3", [255, 128, 0], "", ""),
        ("thumb2", [255, 128, 0], "", ""),
        ("thumb1", [255, 128, 0], "", ""),
        ("forefinger4", [255, 153, 255], "", ""),
        ("forefinger3", [255, 153, 255], "", ""),
        ("forefinger2", [255, 153, 255], "", ""),
        ("forefinger1", [255, 153, 255], "", ""),
        ("middle_finger4", [102, 178, 255], "", ""),
        ("middle_finger3", [102, 178, 255], "", ""),
        ("middle_finger2", [102, 178, 255], "", ""),
        ("middle_finger1", [102, 178, 255], "", ""),
        ("ring_finger4", [255, 51, 51], "", ""),
        ("ring_finger3", [255, 51, 51], "", ""),
        ("ring_finger2", [255, 51, 51], "", ""),
        ("ring_finger1", [255, 51, 51], "", ""),
        ("pinky_finger4", [0, 255, 0], "", ""),
        ("pinky_finger3", [0, 255, 0], "", ""),
        ("pinky_finger2", [0, 255, 0], "", ""),
        ("pinky_finger1", [0, 255, 0], "", ""),
        ("wrist", [255, 255, 255], "", ""),
    ],
    [
        (("wrist", "thumb1"), [255, 128, 0]),
        (("thumb1", "thumb2"), [255, 128, 0]),
        (("thumb2", "thumb3"), [255, 128, 0]),
        (("thumb3", "thumb4"), [255, 128, 0]),
        (("wrist", "forefinger1"), [255, 153, 255]),
        (("forefinger1", "forefinger2"), [255, 153, 255]),
        (("forefinger2", "forefinger3"), [255, 153, 255]),
        (("forefinger3", "forefinger4"), [255, 153, 255]),
        (("wrist", "middle_finger1"), [102, 178, 255]),
        (("middle_finger1", "middle_finger2"), [102, 178, 255]),
        (("middle_finger2", "middle_finger3"), [102, 178, 255]),
        (("middle_finger3", "middle_finger4"), [102, 178, 255]),
        (("wrist", "ring_finger1"), [255, 51, 51]),
        (("ring_finger1", "ring_finger2"), [255, 51, 51]),
        (("ring_finger2", "ring_finger3"), [255, 51, 51]),
        (("ring_finger3", "ring_finger4"), [255, 51, 51]),
        (("wrist", "pinky_finger1"), [0, 255, 0]),
        (("pinky_finger1", "pinky_finger2"), [0, 255, 0]),
        (("pinky_finger2", "pinky_finger3"), [0, 255, 0]),
        (("pinky_finger3", "pinky_finger4"), [0, 255, 0]),
    ],
    [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0],
    [],
)
