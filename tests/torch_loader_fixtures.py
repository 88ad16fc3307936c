"""Picklable datasets and readers of the loader tests. The loader's workers
are spawned processes that import what they unpickle, so these live in a
module that imports neither JAX nor the JAX package."""
import os
import random

import numpy as np


class IndexDataset:
    """Sample k is (k, a draw from the dataset's rng, the worker's pid)."""

    def __init__(self, n: int):
        self.n = n
        self.rng = random.Random(0)

    def __len__(self):
        return self.n

    def __getitem__(self, k):
        return k, self.rng.random(), os.getpid()


class StillFrames:
    """``frame_reader``: the same seeded (48, 64, 3) frame at every index (no
    motion, so no flow gate triggers)."""

    def __call__(self, path, idxs):
        frame = np.random.default_rng(len(path)).integers(0, 255, (48, 64, 3))
        return np.repeat(frame[None].astype(np.uint8), len(idxs), axis=0)
