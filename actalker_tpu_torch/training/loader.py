"""Prefetching batch loader for training, on ``torch.utils.data.DataLoader``
worker processes.

The JAX package's loader (``actalker_tpu/training/loader.py``) decodes on a
thread pool, on the premise that decode releases the interpreter lock; it
ran slower with 8 threads than with 4, so the per-sample work (resize,
crops, Farnebäck flow, augmentation) holds the lock. Here each
worker is a process started with the ``spawn`` method (safe in a process
that holds CUDA and threads), runs torch on one thread, and builds whole
batches; ``collate`` runs on the consumer, the process that owns the card.

Contract, as the JAX loader's: batch ``i`` is the samples ``[(start +
i * stride + j) mod n for j < batch_size]`` in order, whatever the worker
count. Per-sample randomness lives in the dataset's ``rng``: with
``num_workers=0`` it is the dataset's own and the draws are exactly the JAX
loader's; each worker's copy is reseeded from ``seed`` and its worker id,
so two workers never draw the same augmentation.
"""
from __future__ import annotations

import functools
import random
from typing import Any, Callable, Iterator, Optional, Sequence

import torch
from torch.utils.data import DataLoader, get_worker_info


class BatchIndices:
    """Batch sampler yielding ``[(start + i * step + j) mod n ...]`` for
    i < ``num_batches`` (without end when None)."""

    def __init__(self, n: int, batch_size: int, start: int = 0,
                 step: Optional[int] = None, num_batches: Optional[int] = None):
        self.n, self.batch_size, self.start = n, batch_size, start
        self.step = batch_size if step is None else step
        self.num_batches = num_batches

    def __iter__(self) -> Iterator[list]:
        bi = 0
        while self.num_batches is None or bi < self.num_batches:
            yield [(self.start + bi * self.step + j) % self.n
                   for j in range(self.batch_size)]
            bi += 1


def worker_seed(seed: int, worker_id: int) -> int:
    """The seed of worker ``worker_id``'s copy of the dataset's ``rng``."""
    return seed * 1_000_003 + worker_id + 1


def _init_worker(seed: int, worker_id: int) -> None:
    torch.set_num_threads(1)     # one core per worker: the flow's convs
    ds = get_worker_info().dataset
    if hasattr(ds, "rng"):
        ds.rng = random.Random(worker_seed(seed, worker_id))


def prefetch_batches(
    dataset: Sequence[Any],
    batch_size: int,
    collate: Callable[[list], Any],
    num_workers: int = 4,
    depth: int = 2,
    start: int = 0,
    num_batches: Optional[int] = None,
    stride: Optional[int] = None,
    seed: int = 0,
) -> Iterator[Any]:
    """Yield ``collate([dataset[i] ...])`` batches with about ``depth``
    batches in flight on ``num_workers`` worker processes (each builds one
    batch at a time, ``ceil(depth / num_workers)`` ahead);
    ``num_workers=0`` iterates synchronously with the same indices.

    ``stride`` is the index distance between consecutive batches (default
    ``batch_size``): data parallelism sets it to the global batch and
    ``start`` to this process's offset in it. The dataset and its readers
    must pickle (module-level classes). The workers stop when the
    generator is closed or exhausted."""
    sampler = BatchIndices(len(dataset), batch_size, start, stride, num_batches)
    if num_workers <= 0:
        for idxs in sampler:
            yield collate([dataset[k] for k in idxs])
        return
    loader = DataLoader(
        dataset, batch_sampler=sampler, num_workers=num_workers,
        collate_fn=list, prefetch_factor=max(1, -(-depth // num_workers)),
        worker_init_fn=functools.partial(_init_worker, seed),
        multiprocessing_context="spawn")
    it = iter(loader)
    try:
        for samples in it:
            yield collate(samples)
    finally:
        del it      # its __del__ stops the workers
