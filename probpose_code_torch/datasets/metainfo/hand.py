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
