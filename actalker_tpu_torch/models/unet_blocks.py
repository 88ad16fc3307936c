"""UNet down/mid/up blocks (spatio-temporal SVD layout), twin of
``actalker_tpu/models/unet_blocks.py``. Torch needs input widths at
construction, so each block takes its input channels (and, going up, the
widths of the skip states it will concatenate)."""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn

from actalker_tpu_torch.models.conditioning import Conditioning
from actalker_tpu_torch.models.resnet import (
    Downsample2D, SpatioTemporalResBlock, Upsample2D)
from actalker_tpu_torch.models.transformer_st import TransformerSpatioTemporal


def _spatial(x, fn):
    b, f, h, w, c = x.shape
    y = fn(x.reshape(b * f, h, w, c))
    return y.reshape(b, f, *y.shape[1:])


class DownBlockSpatioTemporal(nn.Module):
    def __init__(self, cin: int, cout: int, temb: int, num_layers: int = 2,
                 add_downsample: bool = True):
        super().__init__()
        self.resnets = nn.ModuleList([
            SpatioTemporalResBlock(cin if i == 0 else cout, cout, temb, eps=1e-5)
            for i in range(num_layers)])
        self.downsamplers = (nn.ModuleList([Downsample2D(cout)])
                             if add_downsample else None)

    def forward(self, x, temb, image_only_indicator):
        states = []
        for resnet in self.resnets:
            x = resnet(x, temb, image_only_indicator)
            states.append(x)
        if self.downsamplers is not None:
            x = _spatial(x, self.downsamplers[0])
            states.append(x)
        return x, states


class CrossAttnDownBlockSpatioTemporal(nn.Module):
    def __init__(self, cin: int, cout: int, temb: int, heads: int,
                 num_layers: int = 2, transformer_layers: int = 1,
                 context_dim: int = 1024, add_downsample: bool = True,
                 use_mamba: bool = True, ablate: tuple = ()):
        super().__init__()
        self.resnets = nn.ModuleList([
            SpatioTemporalResBlock(cin if i == 0 else cout, cout, temb, eps=1e-6)
            for i in range(num_layers)])
        self.attentions = nn.ModuleList([
            TransformerSpatioTemporal(cout, heads, context_dim,
                                      transformer_layers, use_mamba, ablate)
            for _ in range(num_layers)])
        self.downsamplers = (nn.ModuleList([Downsample2D(cout)])
                             if add_downsample else None)

    def forward(self, x, temb, cond: Conditioning, image_only_indicator):
        states = []
        for resnet, attn in zip(self.resnets, self.attentions):
            x = resnet(x, temb, image_only_indicator)
            x = attn(x, cond, image_only_indicator)
            states.append(x)
        if self.downsamplers is not None:
            x = _spatial(x, self.downsamplers[0])
            states.append(x)
        return x, states


class UNetMidBlockSpatioTemporal(nn.Module):
    def __init__(self, channels: int, temb: int, heads: int,
                 transformer_layers: int = 1, context_dim: int = 1024,
                 ablate: tuple = ()):
        super().__init__()
        self.resnets = nn.ModuleList([
            SpatioTemporalResBlock(channels, channels, temb, eps=1e-5)
            for _ in range(2)])
        self.attentions = nn.ModuleList([TransformerSpatioTemporal(
            channels, heads, context_dim, transformer_layers, False, ablate)])

    def forward(self, x, temb, cond: Conditioning, image_only_indicator):
        x = self.resnets[0](x, temb, image_only_indicator)
        x = self.attentions[0](x, cond, image_only_indicator)
        return self.resnets[1](x, temb, image_only_indicator)


class UpBlockSpatioTemporal(nn.Module):
    def __init__(self, cin: int, skips: Sequence[int], cout: int, temb: int,
                 add_upsample: bool = True):
        super().__init__()
        ins = [cin] + [cout] * (len(skips) - 1)
        self.resnets = nn.ModuleList([
            SpatioTemporalResBlock(i + s, cout, temb, eps=1e-5)
            for i, s in zip(ins, skips)])
        self.upsamplers = (nn.ModuleList([Upsample2D(cout)])
                           if add_upsample else None)

    def forward(self, x, res_states: List, temb, image_only_indicator):
        for resnet in self.resnets:
            x = torch.cat([x, res_states.pop()], dim=-1)
            x = resnet(x, temb, image_only_indicator)
        if self.upsamplers is not None:
            x = _spatial(x, self.upsamplers[0])
        return x


class CrossAttnUpBlockSpatioTemporal(nn.Module):
    def __init__(self, cin: int, skips: Sequence[int], cout: int, temb: int,
                 heads: int, transformer_layers: int = 1,
                 context_dim: int = 1024, add_upsample: bool = True,
                 use_mamba: bool = True, ablate: tuple = ()):
        super().__init__()
        ins = [cin] + [cout] * (len(skips) - 1)
        self.resnets = nn.ModuleList([
            SpatioTemporalResBlock(i + s, cout, temb, eps=1e-5)
            for i, s in zip(ins, skips)])
        self.attentions = nn.ModuleList([
            TransformerSpatioTemporal(cout, heads, context_dim,
                                      transformer_layers, use_mamba, ablate)
            for _ in skips])
        self.upsamplers = (nn.ModuleList([Upsample2D(cout)])
                           if add_upsample else None)

    def forward(self, x, res_states: List, temb, cond: Conditioning,
                image_only_indicator):
        for resnet, attn in zip(self.resnets, self.attentions):
            x = torch.cat([x, res_states.pop()], dim=-1)
            x = resnet(x, temb, image_only_indicator)
            x = attn(x, cond, image_only_indicator)
        if self.upsamplers is not None:
            x = _spatial(x, self.upsamplers[0])
        return x
