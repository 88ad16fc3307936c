"""Batched multi-identity serving, twin of
``actalker_tpu/pipeline/serving.py``: several reference identities in one
sampler loop whose UNet calls stack them (``sampler.sample_video_batch``,
batch order identity, window, CFG branch, frame). The JAX package vmaps its
per-clip program over an identity axis and shards that axis over a device
mesh (``mesh=``); here ``group=`` (a process group, one rank a card) gives
each rank a contiguous block of the identities (``parallel.distributed.
rank_block``: ceil(I / world) each, the last block shorter or empty), and
rank 0 gathers the latents, the call's only collective.

Each identity keeps its own conditioning, region masks and generator, so
identity i of a batch equals ``sample_video`` run on it alone. The SSM
gather's capacity (``UNetConfig.mask_capacity``) is one number for the
whole call, as under the JAX vmap; ``ACTalkerPipeline.generate_latents_batch``
sets it from every identity's masks (over ranks, the MAX of each rank's
fractions) and restores it after the call. With
``capacity_overflow="nan"`` an identity whose mask overflows it comes out
NaN, not clipped, and the others stay finite (the SSM blocks poison per
batch row).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from actalker_tpu_torch.pipeline import sampler
from actalker_tpu_torch.pipeline.sampler import CondBuffers, SamplerConfig, SamplerPlan

__all__ = ["sample_video_batch", "stack_buffers"]


def sample_video_batch(unet, cfg: SamplerConfig, plan: SamplerPlan,
                       buffers: CondBuffers, ref_latents: torch.Tensor,
                       generators: Optional[Sequence[Optional[torch.Generator]]] = None,
                       dtype: torch.dtype = torch.bfloat16,
                       init_noise: Optional[torch.Tensor] = None,
                       group=None) -> Optional[torch.Tensor]:
    """``sampler.sample_video_batch`` over I identities (every tensor field
    of ``buffers`` and ``ref_latents`` with a leading identity axis);
    returns latents (I, buffer_len, h, w, 4) fp32. With ``group`` every
    rank passes all I identities' inputs, runs its block and rank 0 returns
    the latents of all (the others None)."""
    if group is None:
        return sampler.sample_video_batch(unet, cfg, plan, buffers, ref_latents,
                                          generators, dtype, init_noise)
    from actalker_tpu_torch.parallel import distributed as P

    n = ref_latents.shape[0]
    rows = P.rank_block(n, P.world_size(group), P.get_rank(group))
    block = None
    if rows.stop > rows.start:
        mine = dataclasses.replace(buffers, **{
            f.name: getattr(buffers, f.name)[rows] for f in dataclasses.fields(buffers)
            if torch.is_tensor(getattr(buffers, f.name))})
        block = sampler.sample_video_batch(
            unet, cfg, plan, mine, ref_latents[rows],
            None if generators is None else list(generators)[rows], dtype,
            None if init_noise is None else init_noise[rows])
    return P.gather_blocks(block, ref_latents.device, torch.float32, group)


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
