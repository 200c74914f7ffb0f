"""Metric base and evaluators (replaces mmengine BaseMetric).

The port's own copy of ``probpose_code_tpu/evaluation/base_metric.py``:
``BaseMetric.process`` collects per-sample results and ``evaluate`` computes
and prefixes the metrics; ``MultiDatasetEvaluator`` (``:102``, reference
``evaluators/mutli_dataset_evaluator.py:14``) routes the samples of a
CombinedDataset to the metric of their sub-dataset by the ``dataset_name``
of their metainfo. Results are collected in this process only: the
cross-process gather (``_collect_results``, ``:53-65``) comes with the
port's distributed slice.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from probpose_code_torch.datasets import config_metainfo
from probpose_code_torch.datasets.metainfo import parse_pose_metainfo
from probpose_code_torch.registry import EVALUATORS, METRICS


class BaseMetric:
    default_prefix: Optional[str] = None

    def __init__(self, prefix: Optional[str] = None):
        self.prefix = prefix if prefix is not None else self.default_prefix
        self.results: List[Any] = []
        self._dataset_meta: Optional[dict] = None

    @property
    def dataset_meta(self) -> Optional[dict]:
        return self._dataset_meta

    @dataset_meta.setter
    def dataset_meta(self, meta: dict) -> None:
        self._dataset_meta = meta

    def process(self, data_batch: Sequence[dict], data_samples: Sequence[dict]) -> None:
        raise NotImplementedError

    def compute_metrics(self, results: list) -> Dict[str, float]:
        raise NotImplementedError

    def evaluate(self, size: Optional[int] = None) -> Dict[str, float]:
        metrics = self.compute_metrics(self.results)
        self.results.clear()
        if self.prefix:
            metrics = {f"{self.prefix}/{k}": v for k, v in metrics.items()}
        return metrics


@EVALUATORS.register_module()
class Evaluator:
    """Single-dataset evaluator running a list of metrics."""

    def __init__(self, metrics, dataset_meta: Optional[dict] = None):
        if isinstance(metrics, dict):
            metrics = [metrics]
        self.metrics: List[BaseMetric] = [
            METRICS.build(m) if isinstance(m, dict) else m for m in metrics
        ]
        if dataset_meta is not None:
            self.dataset_meta = dataset_meta

    @property
    def dataset_meta(self):
        return getattr(self, "_dataset_meta", None)

    @dataset_meta.setter
    def dataset_meta(self, meta):
        self._dataset_meta = meta
        for m in self.metrics:
            m.dataset_meta = meta

    def process(self, data_samples: Sequence[dict], data_batch=None) -> None:
        for m in self.metrics:
            m.process(data_batch, data_samples)

    def evaluate(self, size: Optional[int] = None) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for m in self.metrics:
            out.update(m.evaluate(size))
        return out


@EVALUATORS.register_module()
class MultiDatasetEvaluator(Evaluator):
    """Route samples to per-dataset metrics by source dataset.

    ``metrics[i]`` evaluates samples originating from ``datasets[i]``.
    Matching is by the ``dataset_name`` carried in each sample's metainfo.
    """

    def __init__(self, metrics, datasets: Sequence[dict], dataset_meta: Optional[dict] = None):
        super().__init__(metrics, dataset_meta=dataset_meta)
        self.dataset_names = []
        for ds_cfg in datasets:
            self.dataset_names.append(parse_pose_metainfo(config_metainfo(ds_cfg))["dataset_name"])
        assert len(self.dataset_names) == len(self.metrics), (
            f"{len(self.dataset_names)} datasets vs {len(self.metrics)} metrics"
        )
        self._name_to_metric = dict(zip(self.dataset_names, self.metrics))

    @Evaluator.dataset_meta.setter
    def dataset_meta(self, meta):
        self._dataset_meta = meta
        for m in self.metrics:
            if m.dataset_meta is None:
                m.dataset_meta = meta

    def process(self, data_samples: Sequence[dict], data_batch=None) -> None:
        routed: Dict[str, list] = {name: [] for name in self.dataset_names}
        for sample in data_samples:
            name = sample.get("dataset_name") if isinstance(sample, dict) else sample.metainfo.get("dataset_name")
            if name not in routed:
                name = self.dataset_names[0]
            routed[name].append(sample)
        for name, samples in routed.items():
            if samples:
                self._name_to_metric[name].process(None, samples)
