"""AutoencoderKL with the temporal decoder (SVD VAE), twin of
``actalker_tpu/models/vae.py``.

Encoder: per-frame KL encoder (conv_in, down blocks of resnets with an
asymmetric-pad stride-2 conv, a single-head attention mid block,
GN/SiLU/conv_out to 2 * latent moments) then ``quant_conv``. Temporal
decoder: conv_in, spatio-temporal resnets around a single-head attention,
up blocks with nearest-2x upsampling, GN/SiLU/conv_out to RGB, then a
(3, 1, 1) conv over frames. Latent scaling factor 0.18215. Frames are NHWC,
video (B, F, H, W, C); parameter names are diffusers'
``AutoencoderKLTemporalDecoder``'s.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from actalker_tpu_torch.models.common import (
    Conv2d, GroupNorm32, Linear, TemporalConv)
from actalker_tpu_torch.models.resnet import (
    ResnetBlock2D, SpatioTemporalResBlock, Upsample2D)
from actalker_tpu_torch.ops.attention import dot_product_attention


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4
    scaling_factor: float = 0.18215

    def tiny(self) -> "VAEConfig":
        return dataclasses.replace(self, block_out_channels=(16, 16, 32, 32),
                                   layers_per_block=1)


class VAEAttention(nn.Module):
    """Single-head spatial self-attention with GroupNorm and residual."""

    def __init__(self, channels: int):
        super().__init__()
        self.group_norm = GroupNorm32(channels, eps=1e-6)
        self.to_q = Linear(channels, channels)
        self.to_k = Linear(channels, channels)
        self.to_v = Linear(channels, channels)
        self.to_out = nn.ModuleList([Linear(channels, channels)])

    def forward(self, x):                  # (N, H, W, C)
        n, h, w, c = x.shape
        y = self.group_norm(x).reshape(n, h * w, 1, c)
        o = dot_product_attention(self.to_q(y), self.to_k(y), self.to_v(y))
        return self.to_out[0](o.reshape(n, h, w, c)) + x


class _Down(nn.Module):
    def __init__(self, cin, cout, layers, add_downsample):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(cin if j == 0 else cout, cout, None, eps=1e-6)
            for j in range(layers)])
        self.downsamplers = (nn.ModuleList([_AsymDown(cout)])
                             if add_downsample else None)


class _AsymDown(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x):                  # pad (0, 1) bottom/right, VALID conv
        return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1)))


class _Mid(nn.Module):
    def __init__(self, resnets, channels):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList([VAEAttention(channels)])


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        boc = cfg.block_out_channels
        self.conv_in = Conv2d(3, boc[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        ch = boc[0]
        for i, out in enumerate(boc):
            self.down_blocks.append(_Down(ch, out, cfg.layers_per_block,
                                          i < len(boc) - 1))
            ch = out
        self.mid_block = _Mid([ResnetBlock2D(ch, ch, None, eps=1e-6)
                               for _ in range(2)], ch)
        self.conv_norm_out = GroupNorm32(ch, eps=1e-6)
        self.conv_out = Conv2d(ch, 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):                  # (N, H, W, 3) -> (N, h, w, 2*latent)
        h = self.conv_in(x)
        for blk in self.down_blocks:
            for r in blk.resnets:
                h = r(h)
            if blk.downsamplers is not None:
                h = blk.downsamplers[0](h)
        h = self.mid_block.resnets[0](h)
        h = self.mid_block.attentions[0](h)
        h = self.mid_block.resnets[1](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


def _st_res(cin, cout):
    return SpatioTemporalResBlock(cin, cout, None, eps=1e-6, temporal_eps=1e-5,
                                  merge_factor=0.0,
                                  switch_spatial_to_temporal_mix=True)


class _Up(nn.Module):
    def __init__(self, cin, cout, layers, add_upsample):
        super().__init__()
        self.resnets = nn.ModuleList([_st_res(cin if j == 0 else cout, cout)
                                      for j in range(layers)])
        self.upsamplers = (nn.ModuleList([Upsample2D(cout)])
                           if add_upsample else None)


class TemporalDecoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        boc = cfg.block_out_channels
        top = boc[-1]
        self.conv_in = Conv2d(cfg.latent_channels, top, 3, padding=1)
        self.mid_block = _Mid([_st_res(top, top)
                               for _ in range(cfg.layers_per_block)], top)
        self.up_blocks = nn.ModuleList()
        ch = top
        rev = list(reversed(boc))
        for i, out in enumerate(rev):
            self.up_blocks.append(_Up(ch, out, cfg.layers_per_block + 1,
                                      i < len(rev) - 1))
            ch = out
        self.conv_norm_out = GroupNorm32(boc[0], eps=1e-6)
        self.conv_out = Conv2d(boc[0], 3, 3, padding=1)
        self.time_conv_out = TemporalConv(3, 3)

    def forward(self, z, image_only_indicator):
        b, f = z.shape[:2]

        def spatial(x, fn):
            y = fn(x.reshape(b * f, *x.shape[2:]))
            return y.reshape(b, f, *y.shape[1:])

        h = spatial(z, self.conv_in)
        h = self.mid_block.resnets[0](h, None, image_only_indicator)
        h = spatial(h, self.mid_block.attentions[0])
        for r in self.mid_block.resnets[1:]:
            h = r(h, None, image_only_indicator)
        for blk in self.up_blocks:
            for r in blk.resnets:
                h = r(h, None, image_only_indicator)
            if blk.upsamplers is not None:
                h = spatial(h, blk.upsamplers[0])
        h = spatial(h, lambda x: self.conv_out(F.silu(self.conv_norm_out(x))))
        return self.time_conv_out(h)


class AutoencoderKLTemporalDecoder(nn.Module):
    """``dtype`` is the compute dtype of encode and decode."""

    def __init__(self, config: VAEConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config, self.dtype = config, dtype
        self.encoder = Encoder(config)
        self.quant_conv = Conv2d(2 * config.latent_channels,
                                 2 * config.latent_channels, 1)
        self.decoder = TemporalDecoder(config)

    def encode(self, x):
        """(N, H, W, 3) -> latent mean (N, h, w, latent), posterior mode."""
        moments = self.quant_conv(self.encoder(x.to(self.dtype)))
        return moments[..., :self.config.latent_channels]

    def decode(self, z, image_only_indicator: Optional[torch.Tensor] = None):
        """(B, F, h, w, latent) -> (B, F, H, W, 3)."""
        if image_only_indicator is None:
            image_only_indicator = torch.zeros(z.shape[:2], dtype=self.dtype,
                                               device=z.device)
        return self.decoder(z.to(self.dtype), image_only_indicator)
