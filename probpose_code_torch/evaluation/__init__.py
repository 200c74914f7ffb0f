"""Evaluation: CocoMetric, CocoWholeBodyMetric, PoseTrack18Metric, the PCK / AUC /
EPE / NME metrics, the evaluators, COCOeval and OKS NMS."""

from .base_metric import BaseMetric, Evaluator, MultiDatasetEvaluator  # noqa: F401
from .cocoeval import COCOeval  # noqa: F401
from .metrics.coco_metric import CocoMetric  # noqa: F401
from .metrics.coco_wholebody_metric import CocoWholeBodyMetric  # noqa: F401
from .metrics.posetrack18_metric import PoseTrack18Metric  # noqa: F401
from .metrics.keypoint_2d_metrics import (  # noqa: F401
    AUC,
    EPE,
    NME,
    JhmdbPCKAccuracy,
    MpiiPCKAccuracy,
    PCKAccuracy,
)
