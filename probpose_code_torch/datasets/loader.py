"""Batching data loader (host side).

The port's own copy of ``probpose_code_tpu/datasets/loader.py``:
``collate_pose_samples`` (``:42``) stacks the pipeline's canvases and warp
matrices into dense NumPy arrays (a JPEG sample gives its file's bytes
instead of a canvas: tens to hundreds of KB where a canvas is 1.2 MB) beside the
list of PoseDataSamples, and a training batch also its heatmap-space
keypoints and labels;
``DataLoader`` (``:254``) yields the JAX loader's batches: the order
(``RandomState(seed + epoch)`` when shuffled), the last partial batch kept or
dropped, and the per-batch seeds (``_task_seed``, ``:316-320``): before
each batch NumPy's and Python's global generators are seeded from
``(seed, epoch, batch id)``, so that a batch's random augmentations do not
depend on which worker ran it or how many there are.

Workers: ``num_workers <= 1`` runs the pipeline in this process (the ambient
generators' states are restored after each batch, as in the JAX loader).
Above that, ``torch.utils.data.DataLoader`` runs it in worker processes
(one whole batch a task, delivered in batch order) started by
multiprocessing's *forkserver*: the JAX loader forks its workers from the
caller (``:225``), and a process that has initialized CUDA must not fork.
The fork server is a fresh process that imports torch and this package once
and forks the workers from itself. As with any such start method, a script
that trains or evaluates must keep its main code under ``if __name__ ==
"__main__":``, since each worker imports the script as a module. With
``persistent_workers`` (the train loader's) the workers live across epochs,
as the JAX pool does: each pickles the dataset once, and a task carries only
``(epoch, batch id)``, from which the worker computes the batch's indices
and seed. ``close`` ends them. The fork server, and multiprocessing's
resource tracker beside it, outlive a pass so that the next one starts its
workers at once; ``stop_workers`` ends both when the caller is done.
"""

from __future__ import annotations

import multiprocessing
import random
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch.utils.data

# the batch's entries that stay on the host, as lists: the JPEG files, which
# the model's device decodes (``PoseModel.device_preprocess_batch``)
HOST_KEYS = ("jpeg", "jpeg_info", "jpeg_path")
# the training labels a batch stacks, from ``gt_instance_labels`` and from
# ``gt_instances`` (``:103-107``, ``:190-196``)
LABELS = ("keypoint_weights", "keypoints_visible_weights")
INSTANCE_LABELS = (("in_image", "in_image"), ("keypoints_visible", "annotated"),
                   ("keypoints_visibility", "keypoints_visibility"))


def _stacked(values) -> np.ndarray:
    """Per-sample arrays stacked; top-down labels carry an instance dim of
    1, which is dropped: (B, 1, ...) -> (B, ...)."""
    v = np.stack([np.asarray(x) for x in values])
    return v[:, 0] if v.ndim >= 3 and v.shape[1] == 1 else v


def collate_pose_samples(samples: List[dict]) -> Dict:
    """The samples of TopdownAffine as one batch, in their order. Those of
    its canvas form give ``canvas`` and ``warp_mat``; those of its JPEG form
    give ``jpeg`` (the files' bytes, each file once), ``jpeg_info`` (their
    headers), ``jpeg_path`` (see ``HOST_KEYS``), and for each crop
    ``jpeg_image`` (its file), ``jpeg_warp_mat`` (image -> crop) and
    ``jpeg_index``, its place in the batch (a ``CombinedDataset`` may mix
    the two forms; the canvases fill the other places, in order).
    The JAX collate names a batch of rotation-free crops ``canvas_sep`` /
    ``warp_mat_sep`` for its separable warp; the port warps every canvas by
    the gather, so keeps one name. A training batch (from
    ``GenerateTarget``) adds ``kpts_hm`` (B, K, 2), ``kpts_visible`` (B, K)
    and the labels: ``keypoint_weights``, ``in_image``, ``annotated`` and
    ``keypoints_visibility``, all float32 (``kpts_hm`` float64 where the
    codec computes in float64: MSRAHeatmap, DoubleProbMap; SimCCLabel's are
    the keypoints' bins). A DoubleProbMap batch's
    ``kpts_hm`` and ``kpts_hm_out`` are its two windows' keypoints (float64,
    as the codec computes them), and it carries what its loss reads and the
    JAX collate drops (``probpose_code_tpu/datasets/loader.py:40-180``):
    ``keypoints_in_image`` and the bbox mask's ``bbox_mask_rect`` (B, 4) and
    ``bbox_mask_mat`` (B, 2, 3), which the device renders. Every batch holds
    ``data_samples``."""
    samples = [s for s in samples if s is not None]
    assert samples, "empty batch after pipeline drops"
    batch: Dict = {}
    canvases = [s for s in samples if "canvas" in s]
    jpegs = [i for i, s in enumerate(samples) if "img_bytes" in s]
    if canvases:
        batch["canvas"] = np.stack([s["canvas"] for s in canvases])
        batch["warp_mat"] = np.stack([s["warp_mat"] for s in canvases]).astype(np.float32)
    if jpegs:
        # each file once (persons of one image share it), ``jpeg_image`` the file of each crop
        files: Dict = {}
        image = [files.setdefault(samples[i]["data_samples"].metainfo.get("img_path") or i, i) for i in jpegs]
        first = sorted(set(image))
        batch["jpeg"] = [samples[i]["img_bytes"] for i in first]
        batch["jpeg_info"] = [samples[i]["jpeg_info"] for i in first]
        batch["jpeg_path"] = [samples[i]["data_samples"].metainfo.get("img_path") for i in first]
        batch["jpeg_image"] = np.searchsorted(first, image).astype(np.int64)
        batch["jpeg_warp_mat"] = np.stack([samples[i]["warp_mat"] for i in jpegs]).astype(np.float32)
        batch["jpeg_index"] = np.asarray(jpegs, np.int64)
    data_samples = [s["data_samples"] for s in samples]
    if "device_kpts_hm" in samples[0]:
        double = "device_kpts_hm_out" in samples[0]
        # float64 where the codec computes so (DoubleProbMap, MSRAHeatmap), else float32
        kpts_type = np.float64 if np.asarray(samples[0]["device_kpts_hm"]).dtype == np.float64 else np.float32
        for name, key in (("device_kpts_hm", "kpts_hm"), ("device_kpts_hm_out", "kpts_hm_out")):
            if name in samples[0]:
                batch[key] = np.stack([np.asarray(s[name]).reshape(-1, 2) for s in samples]).astype(kpts_type)
        batch["kpts_visible"] = np.stack([np.asarray(s["device_kpts_visible"]).reshape(-1)
                                          for s in samples]).astype(np.float32)
        labels, instances = data_samples[0].gt_instance_labels, data_samples[0].gt_instances
        for name in LABELS:
            if name in labels:
                batch[name] = _stacked(d.gt_instance_labels[name] for d in data_samples).astype(np.float32)
        for name, key in INSTANCE_LABELS + ((("keypoints_in_image", "keypoints_in_image"),) if double else ()):
            if name in instances:
                batch[key] = _stacked(d.gt_instances[name] for d in data_samples).astype(np.float32)
        if double and "bbox_mask_rect" in samples[0]:
            batch["bbox_mask_rect"] = np.stack([s["bbox_mask_rect"] for s in samples]).astype(np.int32)
            batch["bbox_mask_mat"] = np.stack([s["bbox_mask_mat"] for s in samples]).astype(np.float32)
    batch["data_samples"] = data_samples
    return batch


def stop_workers() -> None:
    """Stop the fork server and the resource tracker that worker passes
    leave running, and wait for both to exit; a later pass starts them
    again. Neither start method has a public stop, hence the private calls."""
    from multiprocessing import forkserver, resource_tracker

    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


class _Batches(torch.utils.data.Dataset):
    """Batch ``(epoch, i)`` of the loader: its indices and seed computed
    from the epoch and the batch id alone, its samples through the pipeline
    under that seed, collated. Picklable, for the worker processes."""

    def __init__(self, dataset, batch_size: int, shuffle: bool, drop_last: bool, seed: int,
                 with_data_samples: bool = True):
        self.dataset, self.batch_size = dataset, batch_size
        self.shuffle, self.drop_last, self.seed = shuffle, drop_last, seed
        self.with_data_samples = with_data_samples
        self._cached: Tuple[int, List[np.ndarray]] = (-1, [])

    def index_batches(self, epoch: int) -> List[np.ndarray]:
        if self._cached[0] != epoch:
            indices = np.arange(len(self.dataset))
            if self.shuffle:
                np.random.RandomState(self.seed + epoch).shuffle(indices)
            batches = [indices[i:i + self.batch_size] for i in range(0, len(indices), self.batch_size)]
            if self.drop_last and batches and len(batches[-1]) < self.batch_size:
                batches.pop()
            self._cached = (epoch, batches)
        return self._cached[1]

    def task_seed(self, epoch: int, bid: int) -> int:
        return ((self.seed + 1) * 1_000_003 + epoch) * 131_071 + bid

    def __len__(self) -> int:
        return len(self.index_batches(0))

    def __getitem__(self, key: Tuple[int, int]) -> Dict:
        epoch, bid = key
        chunk = self.index_batches(epoch)[bid]
        seed = self.task_seed(epoch, bid)
        np.random.seed(seed % (2**32))
        random.seed(seed)
        batch = collate_pose_samples([self.dataset[int(j)] for j in chunk])
        if not self.with_data_samples:
            batch.pop("data_samples")
        return batch


class _EpochTasks(torch.utils.data.Sampler):
    """The keys of one epoch's batches, ``(epoch, 0..n-1)``; the epoch is
    read from the loader when an epoch's iteration starts."""

    def __init__(self, loader: "DataLoader"):
        self.loader = loader

    def __iter__(self):
        epoch = self.loader.epoch
        return iter([(epoch, i) for i in range(len(self.loader))])

    def __len__(self) -> int:
        return len(self.loader)


def _as_is(batch):
    return batch


class DataLoader:
    """Iterable over collated batches; see the module. ``with_data_samples=
    False`` drops the PoseDataSample list in the worker, before the batch is
    pickled back (the train loop reads only the arrays)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, drop_last: bool = False, num_workers: int = 4,
                 seed: int = 0, with_data_samples: bool = True, persistent_workers: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.persistent_workers = persistent_workers
        self.epoch = 0
        self._tasks = _Batches(dataset, batch_size, shuffle, drop_last, seed, with_data_samples)
        self._workers: Optional[torch.utils.data.DataLoader] = None

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self._tasks.index_batches(self.epoch))

    def load(self, epoch: int, i: int) -> Dict:
        """Batch ``i`` of ``epoch``, made in this process: what a worker
        makes of it. The caller's generators are left as they were."""
        np_state, py_state = np.random.get_state(), random.getstate()
        try:
            return self._tasks[epoch, i]
        finally:
            np.random.set_state(np_state)
            random.setstate(py_state)

    def __iter__(self) -> Iterator[Dict]:
        if self.num_workers <= 1:
            for i in range(len(self)):
                yield self.load(self.epoch, i)
            return
        if self._workers is None or not self.persistent_workers:
            context = multiprocessing.get_context("forkserver")
            context.set_forkserver_preload(["probpose_code_torch.datasets"])
            self._workers = torch.utils.data.DataLoader(
                self._tasks, batch_size=None, sampler=_EpochTasks(self), num_workers=self.num_workers,
                collate_fn=_as_is, multiprocessing_context=context, persistent_workers=self.persistent_workers,
            )
        yield from self._workers

    def close(self) -> None:
        """End the persistent workers, and wait for them (torch has no public
        call for it: the iterator ends them when it is collected)."""
        workers, self._workers = self._workers, None
        iterator = getattr(workers, "_iterator", None)
        if iterator is not None:
            iterator._shutdown_workers()
