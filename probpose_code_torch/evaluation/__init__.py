"""COCO evaluation: the metric, its evaluators, COCOeval and OKS NMS."""

from .base_metric import BaseMetric, Evaluator, MultiDatasetEvaluator  # noqa: F401
from .cocoeval import COCOeval  # noqa: F401
from .metrics.coco_metric import CocoMetric  # noqa: F401
