"""Minimal COCO annotation API (replaces xtcocotools.coco.COCO).

The port's own copy of ``probpose_code_tpu/datasets/coco_api.py:COCO``: a
pure-Python JSON indexer with the image / annotation / category lookups and
``loadRes`` that the datasets and the COCO evaluation use.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np


class COCO:
    def __init__(self, annotation_file: Optional[str] = None, dataset: Optional[dict] = None):
        self.dataset: Dict[str, Any] = {}
        self.anns: Dict[int, dict] = {}
        self.imgs: Dict[int, dict] = {}
        self.cats: Dict[int, dict] = {}
        self.img_to_anns: Dict[int, List[dict]] = defaultdict(list)
        self.cat_to_imgs: Dict[int, List[int]] = defaultdict(list)
        if annotation_file is not None:
            with open(annotation_file, "r") as f:
                self.dataset = json.load(f)
        elif dataset is not None:
            self.dataset = dataset
        if self.dataset:
            self.create_index()

    def create_index(self) -> None:
        for ann in self.dataset.get("annotations", []):
            self.anns[ann["id"]] = ann
            self.img_to_anns[ann["image_id"]].append(ann)
            if "category_id" in ann:
                self.cat_to_imgs[ann["category_id"]].append(ann["image_id"])
        for img in self.dataset.get("images", []):
            self.imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            self.cats[cat["id"]] = cat

    # -- queries ---------------------------------------------------------

    def getImgIds(self, imgIds: Sequence[int] = (), catIds: Sequence[int] = ()) -> List[int]:
        imgIds = _as_list(imgIds)
        catIds = _as_list(catIds)
        if not imgIds and not catIds:
            return sorted(self.imgs.keys())
        ids = set(imgIds) if imgIds else set(self.imgs.keys())
        for cat_id in catIds:
            ids &= set(self.cat_to_imgs.get(cat_id, []))
        return sorted(ids)

    def getAnnIds(
        self,
        imgIds: Union[int, Sequence[int]] = (),
        catIds: Union[int, Sequence[int]] = (),
        areaRng: Sequence[float] = (),
        iscrowd: Optional[bool] = None,
    ) -> List[int]:
        imgIds = _as_list(imgIds)
        catIds = _as_list(catIds)
        if imgIds:
            anns: List[dict] = []
            for img_id in imgIds:
                anns.extend(self.img_to_anns.get(img_id, []))
        else:
            anns = list(self.dataset.get("annotations", []))
        if catIds:
            cat_set = set(catIds)
            anns = [a for a in anns if a.get("category_id") in cat_set]
        if areaRng:
            anns = [a for a in anns if areaRng[0] < a.get("area", 0) < areaRng[1]]
        if iscrowd is not None:
            anns = [a for a in anns if a.get("iscrowd", 0) == iscrowd]
        return [a["id"] for a in anns]

    def getCatIds(self, catNms: Sequence[str] = (), supNms: Sequence[str] = (), catIds: Sequence[int] = ()) -> List[int]:
        cats = list(self.cats.values())
        if catNms:
            cats = [c for c in cats if c.get("name") in set(catNms)]
        if supNms:
            cats = [c for c in cats if c.get("supercategory") in set(supNms)]
        if catIds:
            cats = [c for c in cats if c["id"] in set(catIds)]
        return sorted(c["id"] for c in cats)

    def loadImgs(self, ids: Union[int, Sequence[int]]) -> List[dict]:
        return [self.imgs[i] for i in _as_list(ids)]

    def loadAnns(self, ids: Union[int, Sequence[int]]) -> List[dict]:
        return [self.anns[i] for i in _as_list(ids)]

    def loadCats(self, ids: Union[int, Sequence[int]]) -> List[dict]:
        return [self.cats[i] for i in _as_list(ids)]

    def loadRes(self, results: Union[str, List[dict]]) -> "COCO":
        """Build a result COCO object from a prediction list / json file."""
        if isinstance(results, str):
            with open(results) as f:
                anns = json.load(f)
        else:
            anns = list(results)
        res_dataset = dict(images=list(self.dataset.get("images", [])), categories=list(self.dataset.get("categories", [])))
        for i, ann in enumerate(anns):
            ann.setdefault("id", i + 1)
            if "keypoints" in ann and "area" not in ann and "bbox" not in ann:
                kp = np.array(ann["keypoints"]).reshape(-1, 3)
                xs, ys = kp[:, 0], kp[:, 1]
                x0, x1, y0, y1 = xs.min(), xs.max(), ys.min(), ys.max()
                ann["area"] = float((x1 - x0) * (y1 - y0))
                ann["bbox"] = [float(x0), float(y0), float(x1 - x0), float(y1 - y0)]
        res_dataset["annotations"] = anns
        return COCO(dataset=res_dataset)


def _as_list(x) -> list:
    if x is None:
        return []
    if isinstance(x, (list, tuple, set)):
        return list(x)
    return [x]
