"""Timestep / positional embeddings and the spatial-temporal AlphaBlender.

Twin of ``actalker_tpu/models/embeddings.py``: sinusoidal features with
``flip_sin_to_cos=True, downscale_freq_shift=0``, a two-layer SiLU MLP, and
the learned sigmoid blend between spatial and temporal branches.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from actalker_tpu_torch.models.common import Linear


def sinusoidal_embedding(timesteps: torch.Tensor, dim: int,
                         flip_sin_to_cos: bool = True,
                         downscale_freq_shift: float = 0.0,
                         max_period: float = 10000.0) -> torch.Tensor:
    """(N,) -> (N, dim) float32 sinusoidal features."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    out = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        out = F.pad(out, (0, 1))
    return out


class TimestepEmbedding(nn.Module):
    """linear -> SiLU -> linear."""

    def __init__(self, in_dim: int, embed_dim: int,
                 out_dim: Optional[int] = None):
        super().__init__()
        self.linear_1 = Linear(in_dim, embed_dim)
        self.linear_2 = Linear(embed_dim, out_dim or embed_dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class AlphaBlender(nn.Module):
    """x = a * spatial + (1 - a) * temporal with a = sigmoid(mix_factor);
    ``image_only_indicator`` (B, F) forces a = 1 per (batch, frame)."""

    def __init__(self, alpha_init: float = 0.5,
                 switch_spatial_to_temporal_mix: bool = False):
        super().__init__()
        self.mix_factor = nn.Parameter(torch.tensor([alpha_init]))
        self.switch = switch_spatial_to_temporal_mix

    def forward(self, x_spatial, x_temporal, image_only_indicator):
        alpha = torch.where(image_only_indicator.bool(),
                            torch.ones((), device=x_spatial.device),
                            torch.sigmoid(self.mix_factor.float())[..., None])
        if x_spatial.ndim == 3:          # (B*F, S, C)
            alpha = alpha.reshape(-1)[:, None, None]
        elif x_spatial.ndim == 5:        # (B, F, H, W, C)
            alpha = alpha[:, :, None, None, None]
        else:
            raise ValueError(f"unexpected ndim {x_spatial.ndim}")
        alpha = alpha.to(x_spatial.dtype)
        if self.switch:
            alpha = 1.0 - alpha
        return alpha * x_spatial + (1.0 - alpha) * x_temporal
