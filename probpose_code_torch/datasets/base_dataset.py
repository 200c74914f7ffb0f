"""COCO-style top-down pose datasets (host side).

The port's own copy of ``probpose_code_tpu/datasets/base_dataset.py``
(``:26-368``; reference ``base_coco_style_dataset.py`` and
``dataset_wrappers.py``): ``Compose``, ``BaseCocoStyleDataset`` (annotation
parsing with the ProbPose ``keypoints_visibility`` (v==2) flag and
``pad_to_contain``, detector boxes from a ``bbox_file``, the top-down
organization and filters), the body datasets under their metainfo
(``BODY_DATASETS``: ``CocoDataset``, ``CocoCropDataset`` and those of
``datasets/zoo.py:24-61`` that the body8 and cocktail14 recipes mix,
``HumanArt21Dataset`` among them),
``CocoWholeBodyDataset`` and ``UBody2dDataset`` (133 keypoints), the face
and hand datasets (``FACE_HAND_DATASETS``, ``zoo.py:38-49``, and mmpose's
readings of COCO-WholeBody's faces and hands and of Halpe's hands:
``CocoWholeBodyFaceDataset``, ``CocoWholeBodyHandDataset``,
``HalpeHandDataset``; ``INTERHAND_DATASETS``: ``InterHand2DDoubleDataset``,
``zoo.py:53``, the JAX class's COCO-style reading: mmpose's
``camera_param_file`` and ``joint_file`` fall into its ``**kwargs``), the animal, fashion and ExLPose datasets
(``ANIMAL_FASHION_DATASETS``, ``zoo.py:35``, ``:55-69``, and
``DeepFashionDataset`` with mmpose's ``subset``) and ``CombinedDataset``.
``config_metainfo`` gives the table that a dataset config names.
``data_mode="bottomup"`` comes with the bottom-up slice.
"""

from __future__ import annotations

import copy
import json
import os.path as osp
from typing import Dict, List, Optional, Sequence

import numpy as np

from probpose_code_torch.registry import DATASETS, TRANSFORMS
from probpose_code_torch.structures.keypoint import find_min_padding_exact

from . import transforms  # noqa: F401  (registers the transforms)
from .coco_api import COCO
from .metainfo import parse_pose_metainfo


class Compose:
    """Sequential transform pipeline; a transform returning None drops the sample."""

    def __init__(self, transforms: Sequence):
        self.transforms = [TRANSFORMS.build(t) if isinstance(t, dict) else t for t in (transforms or [])]

    def __call__(self, results: dict) -> Optional[dict]:
        for t in self.transforms:
            results = t(results)
            if results is None:
                return None
        return results


@DATASETS.register_module()
class BaseCocoStyleDataset:
    METAINFO: dict = dict(dataset_name="coco")

    def __init__(
        self,
        ann_file: str = "",
        bbox_file: Optional[str] = None,
        data_mode: str = "topdown",
        metainfo: Optional[dict] = None,
        data_root: str = "",
        data_prefix: dict = dict(img=""),
        filter_cfg: Optional[dict] = None,
        pipeline: Sequence = (),
        test_mode: bool = False,
        sample_interval: int = 1,
        **kwargs,
    ):
        if data_mode != "topdown":
            raise NotImplementedError(f"data_mode {data_mode!r}: the port's datasets are top-down only")
        if bbox_file and not test_mode:
            raise ValueError("bbox_file requires test_mode")
        self.ann_file = osp.join(data_root, ann_file) if data_root and not osp.isabs(ann_file) else ann_file
        self.bbox_file = bbox_file
        self.data_root = data_root
        self.data_prefix = {k: osp.join(data_root, v) if data_root and not osp.isabs(v) else v
                            for k, v in data_prefix.items()}
        self.filter_cfg = filter_cfg
        self.test_mode = test_mode
        self.sample_interval = sample_interval

        raw_metainfo = metainfo if metainfo is not None else self.class_metainfo(kwargs)
        self._metainfo = parse_pose_metainfo(dict(raw_metainfo))
        self.pipeline = Compose(pipeline)

        self.data_list = self.load_data_list()

    # -- metainfo --------------------------------------------------------

    @classmethod
    def class_metainfo(cls, dataset_cfg: dict) -> dict:
        """The class's table for a config that names none (``dataset_cfg``
        is the rest of the config; DeepFashion reads its ``subset``)."""
        return dict(cls.METAINFO)

    @property
    def metainfo(self) -> dict:
        return self._metainfo

    # -- loading ---------------------------------------------------------

    def load_data_list(self) -> List[dict]:
        if self.bbox_file:
            instance_list = self._load_detection_results()
        else:
            instance_list = self._load_annotations()

        return self.filter_data(self._get_topdown_data_infos(instance_list))

    def _load_annotations(self):
        assert osp.exists(self.ann_file), f"Annotation file `{self.ann_file}` does not exist"
        self.coco = COCO(self.ann_file)
        if "categories" in self.coco.dataset:
            self._metainfo["CLASSES"] = self.coco.loadCats(self.coco.getCatIds())

        instance_list: List[dict] = []
        for img_id in self.coco.getImgIds():
            if img_id % self.sample_interval != 0:
                continue
            img = dict(self.coco.loadImgs(img_id)[0])
            img["img_id"] = img_id
            img["img_path"] = osp.join(self.data_prefix["img"], img["file_name"])

            for ann in self.coco.loadAnns(self.coco.getAnnIds(imgIds=img_id)):
                info = self.parse_data_info(dict(raw_ann_info=ann, raw_img_info=img))
                if info is not None:
                    instance_list.append(info)
        return instance_list

    def parse_data_info(self, raw_data_info: dict) -> Optional[dict]:
        ann = raw_data_info["raw_ann_info"]
        img = raw_data_info["raw_img_info"]
        if "bbox" not in ann or "keypoints" not in ann:
            return None

        img_w, img_h = img["width"], img["height"]
        x, y, w, h = ann["bbox"]
        x1 = np.clip(x, 0, img_w - 1)
        y1 = np.clip(y, 0, img_h - 1)
        x2 = np.clip(x + w, 0, img_w - 1)
        y2 = np.clip(y + h, 0, img_h - 1)
        bbox = np.array([x1, y1, x2, y2], dtype=np.float32).reshape(1, 4)

        _keypoints = np.array(ann["keypoints"], dtype=np.float32).reshape(1, -1, 3)
        keypoints = _keypoints[..., :2]
        # visibility semantics: 'keypoints_visible' = annotated (v>0);
        # 'keypoints_visibility' = actually visible (v==2) — ProbPose flag
        keypoints_visibility = (_keypoints[..., 2] == 2).astype(np.float32)
        keypoints_visible = np.minimum(1, _keypoints[..., 2])

        num_keypoints = ann.get("num_keypoints", int(np.count_nonzero(keypoints.max(axis=2))))

        if "area" in ann:
            area = np.array(ann["area"], dtype=np.float32)
        else:
            area = np.array(np.clip((x2 - x1) * (y2 - y1) * 0.53, 1.0, None), dtype=np.float32)

        pad_to_contain = ann.get("pad_to_contain")
        if pad_to_contain is None:
            pad_to_contain = find_min_padding_exact(bbox, _keypoints.reshape(-1, 3))

        data_info = {
            "img_id": ann["image_id"],
            "img_path": img["img_path"],
            "bbox": bbox,
            "bbox_score": np.ones(1, dtype=np.float32),
            "num_keypoints": num_keypoints,
            "keypoints": keypoints,
            "keypoints_visible": keypoints_visible,
            "keypoints_visibility": keypoints_visibility,
            "pad_to_contain": pad_to_contain,
            "area": area,
            "iscrowd": ann.get("iscrowd", 0),
            "segmentation": ann.get("segmentation", None),
            "id": ann["id"],
            "category_id": np.array(ann["category_id"]),
            "raw_ann_info": copy.deepcopy(ann),
            "source_dataset": self._metainfo["dataset_name"],
        }
        if "crowdIndex" in img:
            data_info["crowd_index"] = img["crowdIndex"]
        return data_info

    def _load_detection_results(self) -> List[dict]:
        """Load detector bboxes (reference :430) for topdown test."""
        assert osp.exists(self.bbox_file), f"bbox file {self.bbox_file} missing"
        self.coco = COCO(self.ann_file)
        with open(self.bbox_file) as f:
            det_results = json.load(f)

        num_keypoints = self._metainfo["num_keypoints"]
        instance_list = []
        id_ = 0
        for det in det_results:
            if det.get("category_id", 1) != 1:
                continue
            img = dict(self.coco.loadImgs(det["image_id"])[0])
            img_path = osp.join(self.data_prefix["img"], img["file_name"])
            x, y, w, h = det["bbox"]
            bbox = np.array([x, y, x + w, y + h], dtype=np.float32).reshape(1, 4)
            instance_list.append(
                {
                    "img_id": det["image_id"],
                    "img_path": img_path,
                    "img_shape": (img["height"], img["width"]),
                    "bbox": bbox,
                    "bbox_score": np.array([det["score"]], dtype=np.float32),
                    "keypoints": np.zeros((1, num_keypoints, 2), dtype=np.float32),
                    "keypoints_visible": np.zeros((1, num_keypoints), dtype=np.float32),
                    "keypoints_visibility": np.zeros((1, num_keypoints), dtype=np.float32),
                    "pad_to_contain": np.full(num_keypoints, -1.0),
                    "id": id_,
                }
            )
            id_ += 1
        return instance_list

    # -- organization ----------------------------------------------------

    @staticmethod
    def _is_valid_instance(data_info: Dict) -> bool:
        if data_info.get("iscrowd", 0):
            return False
        if data_info.get("num_keypoints", 1) == 0:
            return False
        if "bbox" in data_info:
            bbox = data_info["bbox"][0]
            w, h = bbox[2:4] - bbox[:2]
            if w <= 0 or h <= 0:
                return False
        if "keypoints" in data_info and np.max(data_info["keypoints"]) <= 0:
            return False
        return True

    def _get_topdown_data_infos(self, instance_list: List[Dict]) -> List[Dict]:
        if self.bbox_file:
            return instance_list  # detection results: no gt-validity filtering
        return [d for d in instance_list if self._is_valid_instance(d)]

    def filter_data(self, data_list: List[Dict]) -> List[Dict]:
        if not self.filter_cfg or self.test_mode:
            return data_list
        min_kpt = self.filter_cfg.get("min_keypoints", 0)
        if min_kpt:
            data_list = [d for d in data_list if d.get("num_keypoints", min_kpt) >= min_kpt]
        return data_list

    # -- access ----------------------------------------------------------

    def __len__(self) -> int:
        return len(self.data_list)

    def get_data_info(self, idx: int) -> dict:
        info = copy.deepcopy(self.data_list[idx])
        info["upper_body_ids"] = self._metainfo["upper_body_ids"]
        info["lower_body_ids"] = self._metainfo["lower_body_ids"]
        info["flip_pairs"] = self._metainfo["flip_pairs"]
        info["flip_indices"] = self._metainfo["flip_indices"]
        info["dataset_keypoint_weights"] = self._metainfo["dataset_keypoint_weights"]
        info["skeleton_links"] = self._metainfo["skeleton_links"]
        info["dataset_name"] = self._metainfo["dataset_name"]
        return info

    def __getitem__(self, idx: int) -> Optional[dict]:
        return self.prepare_data(idx)

    def prepare_data(self, idx: int) -> Optional[dict]:
        return self.pipeline(self.get_data_info(idx))


# class name -> metainfo table: each dataset is the COCO-style parser under its own table, as the JAX
# package's ``datasets/zoo.py:24-61`` makes them (CropCOCO is the ProbPose cropped-COCO benchmark,
# reference ``datasets/body/cococrop_dataset.py:7``). The JAX ``MpiiDataset`` reads COCO-style files and
# sets no ``head_size``; its ``JhmdbDataset`` keeps JHMDB's 1-based coordinates: the port copies both.
BODY_DATASETS = dict(CocoDataset="coco", CocoCropDataset="coco_crop", AicDataset="aic",
                     CrowdPoseDataset="crowdpose", MpiiDataset="mpii", JhmdbDataset="jhmdb",
                     HalpeDataset="halpe", PoseTrack18Dataset="posetrack18", OCHumanDataset="ochuman",
                     HumanArtDataset="humanart", HumanArt21Dataset="humanart21")
# The face and hand datasets the same way (``datasets/zoo.py:38-49``). The JAX parser takes each box from the
# file's ``bbox``: mmpose's WFLW, 300W and AFLW classes build theirs from ``center`` and ``scale`` (x 200) and
# AFLW's NME norm from ``box_size``, and its Panoptic class sets ``head_size``; the port copies the JAX reading.
FACE_HAND_DATASETS = dict(Face300WDataset="300w", Face300WLPDataset="300wlp", WFLWDataset="wflw",
                          AFLWDataset="aflw", COFWDataset="cofw", LapaDataset="lapa",
                          OneHand10KDataset="onehand10k", FreiHandDataset="freihand2d", Rhd2DDataset="rhd2d",
                          PanopticHand2DDataset="panoptic_hand2d")
# The cocktail14 recipe's InterHand2.6M the same way (``zoo.py:53``): the JAX class's COCO-style reading, mmpose's
# ``camera_param_file`` and ``joint_file`` in its keyword arguments, two hands (42 keypoints) an instance under the
# 21-keypoint table.
INTERHAND_DATASETS = dict(InterHand2DDoubleDataset="interhand2d")
# The animal, fashion and ExLPose datasets the same way (``datasets/zoo.py:35``, ``:55-69``), the JAX reading
# of each file's ``bbox`` too.
ANIMAL_FASHION_DATASETS = dict(AP10KDataset="ap10k", AnimalPoseDataset="animalpose", Horse10Dataset="horse10",
                               MacaqueDataset="macaque", FlyDataset="fly", LocustDataset="locust",
                               ZebraDataset="zebra", ATRWDataset="atrw", AnimalKingdomDataset="ak",
                               DeepFashion2Dataset="deepfashion2", ExlposeDataset="exlpose")
for _name, _table in {**BODY_DATASETS, **FACE_HAND_DATASETS, **INTERHAND_DATASETS, **ANIMAL_FASHION_DATASETS}.items():
    globals()[_name] = DATASETS.register_module(module=type(_name, (BaseCocoStyleDataset,), dict(
        METAINFO=dict(dataset_name=_table), __doc__=f"The COCO-style dataset under the {_table!r} metainfo.")))
del _name, _table


@DATASETS.register_module()
class DeepFashionDataset(BaseCocoStyleDataset):
    """DeepFashion's landmarks (mmpose's ``datasets/fashion/
    deepfashion_dataset.py``): ``subset`` "full", "upper" or "lower" picks
    the 8-, 6- or 4-keypoint table (``deepfashion_<subset>``), and any other
    value raises, as mmpose's does. Without a ``subset`` the set is the full
    one (mmpose raises; one shipped config of 8 outputs sets none, and the
    JAX class reads it so). The JAX class (``datasets/zoo.py:68``)
    takes ``subset`` into its ``**kwargs`` and reads every subset under the
    8-keypoint table, so the upper and lower configs' 6 and 4 keypoints meet
    8 flip indices; the port departs from it."""

    METAINFO: dict = dict(dataset_name="deepfashion_full")
    SUBSETS = ("full", "upper", "lower")

    @classmethod
    def class_metainfo(cls, dataset_cfg: dict) -> dict:
        subset = dataset_cfg.get("subset", "full")
        if subset not in cls.SUBSETS:
            raise ValueError(f"DeepFashionDataset: subset {subset!r}, expected one of {cls.SUBSETS}")
        return dict(dataset_name=f"deepfashion_{subset}")


def config_metainfo(dataset_cfg: Optional[dict]) -> dict:
    """The raw metainfo that a dataset config gives its set: the config's
    ``metainfo``, else its class's table (``class_metainfo``), else COCO's
    (the JAX ``init_model``'s and runner's default)."""
    dataset_cfg = dict(dataset_cfg or {})
    if dataset_cfg.get("metainfo"):
        return dict(dataset_cfg["metainfo"])
    kind = dataset_cfg.pop("type", None)
    cls = DATASETS.get(kind) if isinstance(kind, str) else kind
    return cls.class_metainfo(dataset_cfg) if hasattr(cls, "class_metainfo") else dict(dataset_name="coco")


@DATASETS.register_module()
class CocoWholeBodyDataset(BaseCocoStyleDataset):
    """COCO-WholeBody (the JAX package's ``datasets/zoo.py:91-143``; reference
    ``datasets/wholebody/coco_wholebody_dataset.py``): the 133 keypoints of an
    annotation's body, foot, face and hand fields in one array, its
    ``num_keypoints`` the count of annotated ones among them."""

    METAINFO: dict = dict(dataset_name="coco_wholebody")
    PARTS = ("keypoints", "foot_kpts", "face_kpts", "lefthand_kpts", "righthand_kpts")

    def parse_data_info(self, raw_data_info: dict) -> Optional[dict]:
        ann = raw_data_info["raw_ann_info"]
        if "bbox" not in ann or "keypoints" not in ann:
            return None
        merged = dict(ann, keypoints=[v for part in self.PARTS for v in ann.get(part, [])])
        info = super().parse_data_info(dict(raw_data_info, raw_ann_info=merged))
        info["num_keypoints"] = int(np.count_nonzero(info["keypoints_visible"]))
        info["raw_ann_info"] = copy.deepcopy(ann)
        info.pop("crowd_index", None)
        return info


@DATASETS.register_module()
class UBody2dDataset(CocoWholeBodyDataset):
    """UBody-2D: COCO-WholeBody's layout under the ``ubody2d`` table, as
    mmpose's ``UBody2dDataset`` (a ``CocoWholeBodyDataset`` that keeps every
    ``sample_interval``-th image). The JAX class (``datasets/zoo.py:66``)
    reads only the 17 body keypoints against the 133-keypoint table, so
    ``RandomFlip``'s flip indices run past its rows; the port departs from
    it."""

    METAINFO: dict = dict(dataset_name="ubody2d")


@DATASETS.register_module()
class CocoWholeBodyFaceDataset(BaseCocoStyleDataset):
    """The faces of COCO-WholeBody (mmpose's ``datasets/face/
    coco_wholebody_face_dataset.py``): an annotation's 68 ``face_kpts`` in
    its ``face_box`` (x, y, w, h, clipped to the image), none where
    ``face_valid`` is false or every ``face_kpts`` value is 0. The JAX class
    (``datasets/zoo.py:44``) is the COCO parser under the 68-keypoint table:
    it reads the body's 17 ``keypoints`` in the person's box, and
    ``RandomFlip``'s 68 flip indices run past them; the port departs from it.
    Each instance's ``area`` is the base parser's for a file without one, of
    the face box."""

    METAINFO: dict = dict(dataset_name="coco_wholebody_face")

    def parse_data_info(self, raw_data_info: dict) -> Optional[dict]:
        ann = raw_data_info["raw_ann_info"]
        if not ann.get("face_valid", False) or max(ann.get("face_kpts", [0])) <= 0:
            return None
        face = {k: v for k, v in ann.items() if k not in ("area", "num_keypoints", "pad_to_contain")}
        face.update(bbox=ann["face_box"], keypoints=ann["face_kpts"])
        info = super().parse_data_info(dict(raw_data_info, raw_ann_info=face))
        info["raw_ann_info"] = copy.deepcopy(ann)
        info.pop("crowd_index", None)
        return info


def _hand_info(ann, img, bbox, kpts, instance_id, source) -> dict:
    """One hand's instance: ``bbox`` (1, 4) x1 y1 x2 y2 and ``kpts`` (21, 3)
    (x, y, v), the fields the base parser gives an instance."""
    _keypoints = np.asarray(kpts, np.float32).reshape(1, -1, 3)
    return {
        "img_id": ann["image_id"],
        "img_path": img["img_path"],
        "bbox": bbox,
        "bbox_score": np.ones(1, dtype=np.float32),
        "num_keypoints": int(np.count_nonzero(_keypoints[..., :2].max(axis=2))),
        "keypoints": _keypoints[..., :2],
        "keypoints_visible": np.minimum(1, _keypoints[..., 2]),
        "keypoints_visibility": (_keypoints[..., 2] == 2).astype(np.float32),
        "pad_to_contain": find_min_padding_exact(bbox, _keypoints.reshape(-1, 3)),
        "area": np.array(np.clip((bbox[0, 2] - bbox[0, 0]) * (bbox[0, 3] - bbox[0, 1]) * 0.53, 1.0, None),
                         dtype=np.float32),
        "iscrowd": ann.get("iscrowd", 0),
        "segmentation": ann.get("segmentation", None),
        "id": instance_id,
        "category_id": np.array(ann["category_id"]),
        "raw_ann_info": copy.deepcopy(ann),
        "source_dataset": source,
    }


class _HandDataset(BaseCocoStyleDataset):
    """One 21-keypoint instance a hand, left then right for each non-crowd
    annotation of each image (``sample_interval`` is read by neither mmpose
    class); the instance ``id`` counts the hands from 0, as mmpose's does.
    ``hands(ann)`` yields a hand's (bbox (1, 4), keypoints (21, 3)) or
    nothing."""

    METAINFO: dict = dict(dataset_name="coco_wholebody_hand")

    def hands(self, ann):
        raise NotImplementedError

    def _load_annotations(self):
        assert osp.exists(self.ann_file), f"Annotation file `{self.ann_file}` does not exist"
        self.coco = COCO(self.ann_file)
        if "categories" in self.coco.dataset:
            self._metainfo["CLASSES"] = self.coco.loadCats(self.coco.getCatIds())
        instance_list: List[dict] = []
        for img_id in self.coco.getImgIds():
            img = dict(self.coco.loadImgs(img_id)[0])
            img["img_id"] = img_id
            img["img_path"] = osp.join(self.data_prefix["img"], img["file_name"])
            for ann in self.coco.loadAnns(self.coco.getAnnIds(imgIds=img_id, iscrowd=False)):
                for bbox, kpts in self.hands(ann):
                    instance_list.append(_hand_info(ann, img, bbox, kpts, len(instance_list),
                                                    self._metainfo["dataset_name"]))
        return instance_list


@DATASETS.register_module()
class CocoWholeBodyHandDataset(_HandDataset):
    """The hands of COCO-WholeBody (mmpose's ``datasets/hand/
    coco_wholebody_hand_dataset.py``): for each hand whose
    ``<side>hand_valid`` is true and whose ``<side>hand_kpts`` are not all
    0, its 21 keypoints in its ``<side>hand_box`` (x, y, w, h; not
    clipped). The JAX class (``datasets/zoo.py:50``) is the COCO parser
    under the 21-keypoint table: it reads the body's 17 ``keypoints`` in the
    person's box, one instance a person; the port departs from it."""

    def hands(self, ann):
        for side in ("left", "right"):
            kpts = ann.get(f"{side}hand_kpts")
            if ann.get(f"{side}hand_valid", False) and kpts and max(kpts) > 0:
                x, y, w, h = ann[f"{side}hand_box"]
                yield np.array([[x, y, x + w, y + h]], np.float32), kpts


@DATASETS.register_module()
class HalpeHandDataset(_HandDataset):
    """The hands of Halpe-FullBody's 136 keypoints (mmpose's
    ``datasets/hand/halpe_hand_dataset.py``): rows 94-114 the left hand and
    115-135 the right, one instance for each hand with an annotated
    keypoint (v > 0), its box the least one (x1, y1, x2, y2) that holds the
    annotated keypoints. The JAX class (``datasets/zoo.py:52``) is the COCO
    parser under the 21-keypoint table: it reads all 136 rows against it;
    the port departs from it."""

    SIDES = (("left", 94), ("right", 115))

    def hands(self, ann):
        rows = np.asarray(ann.get("keypoints", []), np.float32).reshape(-1, 3)
        if len(rows) != 136:
            return
        for _, first in self.SIDES:
            kpts = rows[first:first + 21]
            annotated = kpts[:, 2] > 0
            if annotated.any():
                xy = kpts[annotated, :2]
                yield np.concatenate([xy.min(0), xy.max(0)]).reshape(1, 4).astype(np.float32), kpts


@DATASETS.register_module()
class CombinedDataset:
    """Concatenation of sub-datasets under a shared pipeline (reference
    ``dataset_wrappers.py``). A sample goes through its sub-dataset's own
    pipeline first (such as AIC's ``KeypointConverter`` to COCO's 17
    keypoints), then takes the shared metainfo keys, then the shared
    pipeline, as mmpose's ``CombinedDataset.get_data_info`` does
    (``self.datasets[i][j]``). The JAX class reads the sub-dataset's
    ``get_data_info``, which skips the sub-pipeline. Its
    ``sample_ratio_factor`` (resampling for training mixes) is set by no
    config and not ported."""

    def __init__(self, metainfo: dict, datasets: Sequence[dict], pipeline: Sequence = (), test_mode: bool = False,
                 **kwargs):
        self.datasets = [DATASETS.build(d) for d in datasets]
        self._lens = [len(d) for d in self.datasets]
        self._metainfo = parse_pose_metainfo(dict(metainfo))
        self.pipeline = Compose(pipeline)
        self.test_mode = test_mode

    @property
    def metainfo(self) -> dict:
        return self._metainfo

    def __len__(self) -> int:
        return sum(self._lens)

    def _map_index(self, index: int):
        for i, n in enumerate(self._lens):
            if index < n:
                return i, index
            index -= n
        raise IndexError(index)

    def get_data_info(self, idx: int) -> Optional[dict]:
        """Sample ``idx`` through its sub-dataset's pipeline (None where that
        drops it), with the shared metainfo keys."""
        ds_idx, sample_idx = self._map_index(idx)
        info = self.datasets[ds_idx][sample_idx]
        if info is None:
            return None
        if np.shape(info["keypoints"])[1] != self._metainfo["num_keypoints"]:
            raise ValueError(
                f"CombinedDataset ({self._metainfo['dataset_name']}): a sample of sub-dataset {ds_idx} "
                f"({type(self.datasets[ds_idx]).__name__}) has {np.shape(info['keypoints'])[1]} keypoints, the "
                f"combined set {self._metainfo['num_keypoints']}; its pipeline needs a KeypointConverter")
        # shared metainfo keys override per-sub-dataset values (reference)
        for key in ("upper_body_ids", "lower_body_ids", "flip_pairs", "flip_indices",
                    "dataset_keypoint_weights", "skeleton_links"):
            info[key] = self._metainfo[key]
        return info

    def __getitem__(self, idx: int) -> Optional[dict]:
        info = self.get_data_info(idx)
        return None if info is None else self.pipeline(info)
