"""Metainfo of the face datasets: 300W and 300W-LP (68 keypoints each),
WFLW (98), COFW (29), AFLW (19), LaPa (106) and COCO-WholeBody-Face (68).

Factual dataset metadata (keypoint names, left-right symmetry, joint loss
weights and OKS sigmas), the port"s own copy of the reference metainfo files
``configs/_base_/datasets/<name>.py`` as the JAX package extracted them
(``probpose_code_tpu/datasets/metainfo/data/<name>.json``). Every keypoint
of a face table is ``<prefix>-<i>`` in red, of no body type (so
``RandomHalfBody`` finds no upper or lower ids), and no table has a
skeleton; 300W-LP"s table pairs no keypoints for the flip.
"""

from .body import table

_RED = [255, 0, 0]


def face_table(name, num, pairs, joint_weights=None, sigmas=(), prefix="kpt") -> dict:
    """A raw metainfo dict of ``num`` keypoints named ``<prefix>-<i>``,
    ``pairs`` the (i, j) keypoints that swap under a horizontal flip."""
    swap = {}
    for i, j in pairs:
        swap[i], swap[j] = j, i
    keypoints = [(f"{prefix}-{i}", _RED, "", f"{prefix}-{swap[i]}" if i in swap else "") for i in range(num)]
    return table(name, keypoints, [], list(joint_weights or [1.0] * num), list(sigmas))


# the 68-point markup's pairs (300W, COCO-WholeBody-Face)
_PAIRS_68 = [(0, 16), (1, 15), (2, 14), (3, 13), (4, 12), (5, 11), (6, 10), (7, 9), (17, 26), (18, 25), (19, 24),
             (20, 23), (21, 22), (31, 35), (32, 34), (36, 45), (37, 44), (38, 43), (39, 42), (40, 47), (41, 46),
             (48, 54), (49, 53), (50, 52), (55, 59), (56, 58), (60, 64), (61, 63), (65, 67)]

FACE_300W = face_table("300w", 68, _PAIRS_68)
FACE_300WLP = face_table("300wlp", 68, [])


WFLW = face_table(
    "wflw", 98,
    [(0, 32), (1, 31), (2, 30), (3, 29), (4, 28), (5, 27), (6, 26), (7, 25), (8, 24), (9, 23), (10, 22), (11, 21),
    (12, 20), (13, 19), (14, 18), (15, 17), (33, 46), (34, 45), (35, 44), (36, 43), (37, 42), (38, 50), (39, 49),
    (40, 48), (41, 47), (55, 59), (56, 58), (60, 72), (61, 71), (62, 70), (63, 69), (64, 68), (65, 75), (66, 74),
    (67, 73), (76, 82), (77, 81), (78, 80), (83, 87), (84, 86), (88, 92), (89, 91), (93, 95), (96, 97)],
)


COFW = face_table(
    "cofw", 29,
    [(0, 1), (2, 3), (4, 6), (5, 7), (8, 9), (10, 11), (12, 14), (13, 15), (16, 17), (18, 19), (22, 23)],
)


AFLW = face_table(
    "aflw", 19,
    [(0, 5), (1, 4), (2, 3), (6, 11), (7, 10), (8, 9), (12, 14), (15, 17)],
)


LAPA = face_table(
    "lapa", 106,
    [(0, 32), (1, 31), (2, 30), (3, 29), (4, 28), (5, 27), (6, 26), (7, 25), (8, 24), (9, 23), (10, 22), (11, 21),
    (12, 20), (13, 19), (14, 18), (15, 17), (33, 46), (34, 45), (35, 44), (36, 43), (37, 42), (38, 50), (39, 49),
    (40, 48), (41, 47), (55, 65), (56, 64), (57, 63), (58, 62), (59, 61), (66, 79), (67, 78), (68, 77), (69, 76),
    (70, 75), (71, 82), (72, 81), (73, 80), (74, 83), (84, 90), (85, 89), (86, 88), (91, 95), (92, 94), (96, 100),
    (97, 99), (101, 103), (104, 105)],
    joint_weights=[0.8] * 33 + [1.0] * 33 + [2.0] * 8 + [1.0] + [2.0] * 8 + [1.0] + [1.5] * 20 + [1.0] * 2,
)


COCO_WHOLEBODY_FACE = face_table(
    "coco_wholebody_face", 68,
    _PAIRS_68,
    sigmas=[0.042, 0.043, 0.044, 0.043, 0.04, 0.035, 0.031, 0.025, 0.02, 0.023, 0.029, 0.032, 0.037, 0.038, 0.043,
    0.041, 0.045, 0.013, 0.012, 0.011, 0.011, 0.012, 0.012, 0.011, 0.011, 0.013, 0.015, 0.009, 0.007, 0.007,
    0.007, 0.012, 0.009, 0.008, 0.016, 0.01, 0.017, 0.011, 0.009, 0.011, 0.009, 0.007, 0.013, 0.008, 0.011,
    0.012, 0.01, 0.034, 0.008, 0.008, 0.009, 0.008, 0.008, 0.007, 0.01, 0.008, 0.009, 0.009, 0.009, 0.007,
    0.007, 0.008, 0.011, 0.008, 0.008, 0.008, 0.01, 0.008],
    prefix="face",
)
