"""The data-parallel layout: a rank's rows of a global batch and the ZeRO-2
partition of the trainable parameters. Twin of
``actalker_tpu/parallel/mesh.py`` (its ``shard_batch``, ``shard_opt_state``
and ``per_device_bytes``) for the port's one axis, ``dp``.

ZeRO-2 (the reference's ``ds_zero2_8gpu.yaml``) keeps the fp32 master
parameters replicated and divides the AdamW moments and the accumulated
gradient over the ranks. ``ZeroLayout`` lays every trainable parameter out
in one flat buffer (each one 256-byte aligned), padded to ``world *
ceil(N / world)`` elements and cut into buckets of ``world * chunk``
consecutive elements; rank r owns the
r-th chunk of every bucket, so its shard is ``ceil(N / world)`` elements
and a bucket's gradient reaches its owners with one equal-chunk
reduce-scatter (and the updated parameters return with one all-gather).

Tensor parallelism (the JAX package's ``_TP_RULES`` / ``param_pspec`` /
``shard_params``) is not ported: the reference has none (SURVEY §2.8), and
it waits as its own item in ROADMAP queue 1.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch

from actalker_tpu_torch.parallel.distributed import local_batch_slice

# elements of one gradient bucket over all ranks: 128 MiB of fp32 in flight
BUCKET_ELEMS = 1 << 25
# where a parameter may start in the flat buffer: the hand-written kernels
# take fp32 operands (biases, norm affines) as they are and need 16-byte
# alignment; 256 bytes is the caching allocator's own
ALIGN_BYTES = 256
TP_UNPORTED = ("tensor parallelism (--tp > 1) is not ported: the reference "
               "trains data-parallel only (ZeRO-2); see ROADMAP.md queue 1, "
               "item 9")


def shard_batch(batch, world: Optional[int] = None, rank: Optional[int] = None):
    """This rank's rows of a global batch (a NamedTuple such as
    ``TrainBatch``): every tensor field whose leading axis is the batch
    (``latents``' first axis) is sliced, per-sample masks (B, 1, H, W)
    included; None fields pass through."""
    b = batch.latents.shape[0]
    rows = local_batch_slice(b, world, rank)

    def cut(x):
        if torch.is_tensor(x) and x.ndim >= 1 and x.shape[0] == b:
            return x[rows]
        return x

    return type(batch)(*(cut(x) for x in batch))


class Bucket(NamedTuple):
    start: int        # first flat element
    stop: int         # one past the last (start + world * chunk)
    chunk: int        # elements each rank owns
    shard_start: int  # where the rank's chunk sits in its shard
    real: int         # parameter elements in it (the rest is padding)


@dataclasses.dataclass
class ZeroLayout:
    """Flat offsets of the parameters and the bucket / shard geometry for
    ``world`` ranks (see the module docstring). Each parameter starts at a
    multiple of ``align`` elements, so a view of it is as aligned as the
    kernels' operands must be; ``numel`` is the span, gaps included."""

    numels: Sequence[int]
    world: int
    bucket_elems: int = BUCKET_ELEMS
    align: int = 1

    def __post_init__(self):
        self.offsets: List[int] = []
        n = 0
        for k in self.numels:
            n = -(-n // self.align) * self.align
            self.offsets.append(n)
            n += int(k)
        self.numel = n
        self.shard_numel = -(-n // self.world)
        self.padded = self.world * self.shard_numel
        self.chunk = max(1, self.bucket_elems // self.world)
        self.buckets: List[Bucket] = []
        real = [0] * -(-n // (self.world * self.chunk))
        for off, k in zip(self.offsets, self.numels):
            for j in self.buckets_of(off, int(k), len(real)):
                lo, hi = j * self.world * self.chunk, (j + 1) * self.world * self.chunk
                real[j] += min(off + int(k), hi) - max(off, lo)
        start = shard = 0
        for r in real:
            chunk = -(-min(self.world * self.chunk, n - start) // self.world)
            self.buckets.append(Bucket(start, start + self.world * chunk, chunk, shard, r))
            start += self.world * chunk
            shard += chunk

    def buckets_of(self, offset: int, numel: int, n_buckets: Optional[int] = None
                   ) -> range:
        """Indices of the buckets that flat elements [offset, offset +
        numel) touch (every bucket but the last spans world * chunk)."""
        span = self.world * self.chunk
        last = (len(self.buckets) if n_buckets is None else n_buckets) - 1
        if numel == 0:
            return range(0)
        return range(min(offset // span, last),
                     min((offset + numel - 1) // span, last) + 1)


def per_rank_bytes(numel: int, world: int, itemsize: int = 4) -> Dict[str, int]:
    """Bytes one rank holds under ZeRO-2 for ``numel`` trainable
    parameters: the replicated masters (the padded flat buffer), the two
    AdamW moments and the gradient accumulator, each ``ceil(numel /
    world)`` elements. Gradient buckets in flight come on top (at most a
    few of ``BUCKET_ELEMS``)."""
    shard = -(-numel // world)
    out = {"masters": world * shard * itemsize, "moments": 2 * shard * itemsize,
           "grads": shard * itemsize}
    out["total"] = sum(out.values())
    return out
