"""Spatio-temporal transformer: spatial attention + optional SSM control
block + temporal attention, blended per layer.

Twin of ``actalker_tpu/models/transformer_st.py``: the production variant
passes the spatial block's output through ``SS2DCondV10`` (replacing, not
residual), adds the frame-position embedding, runs the temporal block over
the frame-pooled conditioning (``spatial2time``) and mixes with the
AlphaBlender; the mid block uses the same module without the SSM.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from actalker_tpu_torch.models.attention_blocks import (
    BasicTransformerBlock, TemporalBasicTransformerBlock)
from actalker_tpu_torch.models.common import GroupNorm32, Linear
from actalker_tpu_torch.models.conditioning import Conditioning
from actalker_tpu_torch.models.embeddings import (
    AlphaBlender, TimestepEmbedding, sinusoidal_embedding)
from actalker_tpu_torch.models.ssm import SS2DCondV10


class TransformerSpatioTemporal(nn.Module):
    """``ablate``: any subset of {"audio", "vasa", "id", "ssd",
    "cross_attn"} (the reference's ``_wo_*`` variants as config)."""

    def __init__(self, channels: int, heads: int, context_dim: int = 1024,
                 num_layers: int = 1, use_mamba: bool = False,
                 ablate: Tuple[str, ...] = ()):
        super().__init__()
        head_dim = channels // heads
        inner = heads * head_dim
        self.channels = channels
        self.use_audio = "audio" not in ablate
        self.use_vasa = "vasa" not in ablate
        ctx = None if "cross_attn" in ablate else context_dim
        n_ip = int(self.use_audio) + int(self.use_vasa)
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.proj_in = Linear(channels, inner)
        self.time_pos_embed = TimestepEmbedding(channels, channels * 4, channels)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, heads, head_dim, ctx, n_ip)
            for _ in range(num_layers)])
        self.mamba_blocks = nn.ModuleList([
            SS2DCondV10(inner, d_cond=context_dim, use_id="id" not in ablate,
                        use_audio=self.use_audio, use_exp=self.use_vasa,
                        no_scan="ssd" in ablate)
            for _ in range(num_layers)]) if use_mamba else None
        self.temporal_transformer_blocks = nn.ModuleList([
            TemporalBasicTransformerBlock(inner, heads, head_dim, ctx, n_ip)
            for _ in range(num_layers)])
        self.time_mixer = AlphaBlender()   # one mixer, shared across layers
        self.proj_out = Linear(inner, channels)

    def _adapters(self, cond: Conditioning, src: Conditioning):
        toks, scales, masks = [], [], []
        if self.use_audio:
            toks.append(src.audio_tokens)
            scales.append(cond.ip_scales[0])
            masks.append(cond.audio_mask)
        if self.use_vasa:
            toks.append(src.vasa_tokens)
            scales.append(cond.ip_scales[1])
            masks.append(cond.exp_mask)
        return toks, tuple(scales), masks

    def forward(self, x, cond: Conditioning, image_only_indicator):
        b, f, hh, ww, c = x.shape
        residual = x
        # per-frame statistics, as the reference normalizes (B*F, C, H, W)
        h = self.proj_in(self.norm(x.reshape(b * f, hh * ww, c)))
        t_emb = sinusoidal_embedding(
            torch.arange(f, device=x.device), c).repeat(b, 1).to(h.dtype)
        emb = self.time_pos_embed(t_emb)[:, None, :]

        pooled = cond.pooled_over_frames(f)
        ip_toks, ip_scales, ip_masks = self._adapters(cond, cond)
        pool_toks, _, _ = self._adapters(cond, pooled)
        for i, block in enumerate(self.transformer_blocks):
            h = block(h, context=cond.id_tokens, ip_contexts=ip_toks,
                      ip_scales=ip_scales, ip_masks=ip_masks)
            if self.mamba_blocks is not None:
                h = self.mamba_blocks[i](
                    h, cond.id_tokens, cond.audio_tokens, cond.vasa_tokens,
                    cond.audio_mask, cond.exp_mask)
            mix = self.temporal_transformer_blocks[i](
                h + emb, f, context=pooled.id_tokens, ip_contexts=pool_toks,
                ip_scales=ip_scales)
            h = self.time_mixer(h, mix, image_only_indicator)
        h = self.proj_out(h).reshape(b, f, hh, ww, c)
        return h + residual
