"""Resnet blocks for the spatio-temporal UNet and the VAE, on (B, F, H, W, C)
video and NHWC frames.

Twin of ``actalker_tpu/models/resnet.py``: GroupNorm with fp32 statistics,
SiLU and convs; the temporal block's (3, 1, 1) convs run over the frame
axis; ``SpatioTemporalResBlock`` blends the two with an ``AlphaBlender``.
Parameter names are the reference's (diffusers). ``ResnetBlock2D``'s two
GroupNorm / SiLU / 3x3-conv pairs follow the JAX package's switch
(``ACTALKER_RESCONV`` or ``set_resconv_impl``, read at call time): "xla"
(default) runs the modules; "pallas" runs each pair as one
``ops/resconv.gn_silu_conv3x3`` (K7-GN statistics + K8) on the same
parameters, so one state dict serves both.
"""
from __future__ import annotations

import os
from typing import Optional

import torch.nn as nn
import torch.nn.functional as F

from actalker_tpu_torch.models.common import (
    Conv2d, GroupNorm32, Linear, TemporalConv, _conv_tp)
from actalker_tpu_torch.models.embeddings import AlphaBlender
from actalker_tpu_torch.ops.resconv import gn_silu_conv3x3
from actalker_tpu_torch.utils.observability import spanned

_RESCONV = os.environ.get("ACTALKER_RESCONV", "xla")
if _RESCONV not in ("pallas", "xla"):
    raise ValueError(f"ACTALKER_RESCONV={_RESCONV!r}: 'pallas' or 'xla'")


def set_resconv_impl(impl: str) -> None:
    """Set the resnet conv lowering: "pallas" (K8) or "xla" (the default,
    the modules)."""
    global _RESCONV
    if impl not in ("pallas", "xla"):
        raise ValueError(f"resconv impl {impl!r}: 'pallas' or 'xla'")
    _RESCONV = impl


def resconv_impl() -> str:
    """The current resnet conv lowering, "pallas" or "xla"."""
    return _RESCONV


def _gn_silu_conv(norm: GroupNorm32, conv: Conv2d, x):
    """One GroupNorm / SiLU / 3x3-conv pair through K8, on the modules'
    parameters. Under tensor parallelism each rank's K8 applies the whole
    GroupNorm affine for its output channels alone, so the affine's
    gradient, like the input's, is summed over the tp ranks."""
    w, b = norm.weight, norm.bias
    if conv.tp is not None:
        from actalker_tpu_torch.parallel.tensor import copy_to

        w, b = copy_to(w, conv.tp), copy_to(b, conv.tp)
    return _conv_tp(conv, x, lambda t: gn_silu_conv3x3(
        t, w, b, norm.groups, norm.eps, conv.weight, conv.bias))


class ResnetBlock2D(nn.Module):
    def __init__(self, cin: int, cout: int, temb_channels: Optional[int],
                 eps: float = 1e-5):
        super().__init__()
        self.norm1 = GroupNorm32(cin, eps=eps)
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = (Linear(temb_channels, cout)
                              if temb_channels is not None else None)
        self.norm2 = GroupNorm32(cout, eps=eps)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb=None):       # x (N, H, W, C), temb (N, Ct)
        fused = _RESCONV == "pallas"
        if fused:
            h = _gn_silu_conv(self.norm1, self.conv1, x)
        else:
            h = self.conv1(F.silu(self.norm1(x)))
        if self.time_emb_proj is not None and temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, None, None, :]
        if fused:
            h = _gn_silu_conv(self.norm2, self.conv2, h)
        else:
            h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return h + x


class TemporalResnetBlock(nn.Module):
    """Width-preserving: it only ever follows a spatial block of its width."""

    def __init__(self, channels: int, temb_channels: Optional[int],
                 eps: float = 1e-6):
        super().__init__()
        self.norm1 = GroupNorm32(channels, eps=eps)
        self.conv1 = TemporalConv(channels, channels)
        self.time_emb_proj = (Linear(temb_channels, channels)
                              if temb_channels is not None else None)
        self.norm2 = GroupNorm32(channels, eps=eps)
        self.conv2 = TemporalConv(channels, channels)

    def forward(self, x, temb=None):       # x (B, F, H, W, C), temb (B, F, Ct)
        h = self.conv1(F.silu(self.norm1(x)))
        if self.time_emb_proj is not None and temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None, :]
        return self.conv2(F.silu(self.norm2(h))) + x


class SpatioTemporalResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, temb_channels: Optional[int],
                 eps: float = 1e-5, temporal_eps: Optional[float] = None,
                 merge_factor: float = 0.5,
                 switch_spatial_to_temporal_mix: bool = False):
        super().__init__()
        self.spatial_res_block = ResnetBlock2D(cin, cout, temb_channels, eps)
        self.temporal_res_block = TemporalResnetBlock(
            cout, temb_channels,
            temporal_eps if temporal_eps is not None else eps)
        self.time_mixer = AlphaBlender(merge_factor,
                                       switch_spatial_to_temporal_mix)

    @spanned("unet.resnet")
    def forward(self, x, temb, image_only_indicator):
        # x (B, F, H, W, C); temb (B*F, Ct) or None
        b, f, hh, ww, c = x.shape
        xs = self.spatial_res_block(x.reshape(b * f, hh, ww, c), temb)
        xs = xs.reshape(b, f, hh, ww, xs.shape[-1])
        temb_t = temb.reshape(b, f, -1) if temb is not None else None
        xt = self.temporal_res_block(xs, temb_t)
        return self.time_mixer(xs, xt, image_only_indicator)


class Downsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):                  # nearest 2x, then conv
        x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return self.conv(x)
