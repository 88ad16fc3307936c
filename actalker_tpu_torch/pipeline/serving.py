"""Batched multi-identity serving, twin of
``actalker_tpu/pipeline/serving.py``: several reference identities in one
sampler loop whose UNet calls stack them (``sampler.sample_video_batch``,
batch order identity, window, CFG branch, frame). The JAX package vmaps its
per-clip program over an identity axis and can shard that axis over a
device mesh (``mesh=``); identity sharding over several cards waits for the
port's ``parallel/`` slice, and this entry runs on one card.

Each identity keeps its own conditioning, region masks and generator, so
identity i of a batch equals ``sample_video`` run on it alone. The SSM
gather's capacity (``UNetConfig.mask_capacity``) is one number for the
whole call, as under the JAX vmap; ``ACTalkerPipeline.generate_latents_batch``
sets it from every identity's masks and restores it after the call. With
``capacity_overflow="nan"`` an identity whose mask overflows it comes out
NaN, not clipped, and the others stay finite (the SSM blocks poison per
batch row).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from actalker_tpu_torch.pipeline.sampler import CondBuffers, sample_video_batch

__all__ = ["sample_video_batch", "stack_buffers"]


def stack_buffers(per_identity: Sequence[CondBuffers]) -> CondBuffers:
    """Identities' buffers -> one ``CondBuffers`` with a leading identity
    axis on every tensor field (their ``ip_scales`` must agree)."""
    first = per_identity[0]
    if any(b.ip_scales != first.ip_scales for b in per_identity):
        raise ValueError("identities with different ip_scales cannot share a call")
    fields = {}
    for f in dataclasses.fields(first):
        vals = [getattr(b, f.name) for b in per_identity]
        if f.name == "ip_scales":
            continue
        if any(v is None for v in vals):
            if not all(v is None for v in vals):
                raise ValueError(f"{f.name}: set for some identities only")
            fields[f.name] = None
        else:
            fields[f.name] = torch.stack(vals)
    return dataclasses.replace(first, **fields)
