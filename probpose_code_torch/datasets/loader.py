"""Batching data loader (host side).

The port's own copy of ``probpose_code_tpu/datasets/loader.py`` for the val
path: ``collate_pose_samples`` (``:42``) stacks the pipeline's canvases and
warp matrices into dense NumPy arrays beside the list of PoseDataSamples,
and ``DataLoader`` yields the JAX loader's batches (in order, unshuffled,
the last one partial) for the val pipeline. Shuffling, per-batch seeds and
the train labels come with the train half of the pipeline.

Workers: ``num_workers <= 1`` runs the pipeline in this process. Above that,
``torch.utils.data.DataLoader`` runs it in worker processes (one whole batch
a task, delivered in batch order) started by multiprocessing's *forkserver*:
the JAX loader forks its workers from the caller (``:225``), and a process
that has initialized CUDA must not fork. The fork server is a fresh process
that imports torch and this package once and forks the workers from itself.
As with any such start method, a script that evaluates must keep its main
code under ``if __name__ == "__main__":``, since each worker imports the
script as a module. The fork server, and multiprocessing's resource tracker
beside it, outlive a pass so that the next one starts its workers at once;
``stop_workers`` ends both when the caller is done.
"""

from __future__ import annotations

import multiprocessing
from typing import Dict, Iterator, List

import numpy as np
import torch.utils.data


def collate_pose_samples(samples: List[dict]) -> Dict:
    """The samples of TopdownAffine's canvas form as one batch: ``canvas``,
    ``warp_mat`` and ``data_samples``. The JAX collate names a batch of
    rotation-free crops ``canvas_sep`` / ``warp_mat_sep`` for its separable
    warp; the port warps every canvas by the gather, so keeps one name."""
    samples = [s for s in samples if s is not None]
    assert samples, "empty batch after pipeline drops"
    return {
        "canvas": np.stack([s["canvas"] for s in samples]),
        "warp_mat": np.stack([s["warp_mat"] for s in samples]).astype(np.float32),
        "data_samples": [s["data_samples"] for s in samples],
    }


def stop_workers() -> None:
    """Stop the fork server and the resource tracker that worker passes
    leave running, and wait for both to exit; a later pass starts them
    again. Neither start method has a public stop, hence the private calls."""
    from multiprocessing import forkserver, resource_tracker

    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


class _Batches(torch.utils.data.Dataset):
    """Batch ``i`` of the loader: its samples through the pipeline, collated.
    Picklable, for the worker processes."""

    def __init__(self, dataset, batches):
        self.dataset, self.batches = dataset, batches

    def __len__(self) -> int:
        return len(self.batches)

    def __getitem__(self, i: int) -> Dict:
        return collate_pose_samples([self.dataset[int(j)] for j in self.batches[i]])


def _as_is(batch):
    return batch


class DataLoader:
    """Iterable over collated batches, in order; see the module."""

    def __init__(self, dataset, batch_size: int, num_workers: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self) -> Iterator[Dict]:
        indices = np.arange(len(self.dataset))
        tasks = _Batches(self.dataset, [indices[i:i + self.batch_size] for i in range(0, len(indices), self.batch_size)])
        if self.num_workers <= 1:
            for i in range(len(tasks)):
                yield tasks[i]
            return
        context = multiprocessing.get_context("forkserver")
        context.set_forkserver_preload(["probpose_code_torch.datasets"])
        yield from torch.utils.data.DataLoader(
            tasks, batch_size=None, shuffle=False, num_workers=self.num_workers, collate_fn=_as_is,
            multiprocessing_context=context,
        )
