"""The reference's trainable conditioning heads, plain fp32: the audio
window projection (32 context tokens), the expression projection, the
identity projection and the pose guider. Parameter names are ACTalker's,
so one state dict loads here and into the system under test."""
from __future__ import annotations

from typing import Sequence

import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.unet import Conv2d, LayerNorm, Linear


class AudioProjModel(nn.Module):
    """(B, F, window, blocks, channels) -> (B, F, tokens, out): three
    linears with ReLU, then LayerNorm per token."""

    def __init__(self, seq_len=10, blocks=5, channels=384, intermediate_dim=1024,
                 output_dim=1024, context_tokens=32):
        super().__init__()
        self.tokens, self.out = context_tokens, output_dim
        self.proj1 = Linear(seq_len * blocks * channels, intermediate_dim)
        self.proj2 = Linear(intermediate_dim, intermediate_dim)
        self.proj3 = Linear(intermediate_dim, context_tokens * output_dim)
        self.norm = LayerNorm(output_dim)

    def forward(self, x):
        b, f = x.shape[:2]
        h = self.proj3(F.relu(self.proj2(F.relu(self.proj1(x.reshape(b * f, -1))))))
        return self.norm(h.reshape(b * f, self.tokens, self.out)).reshape(
            b, f, self.tokens, self.out)


class VasaProjModel(nn.Module):
    def __init__(self, input_dim=512, output_dim=1018):
        super().__init__()
        self.proj1 = Linear(input_dim, output_dim)
        self.norm = LayerNorm(output_dim)

    def forward(self, x):
        return self.norm(self.proj1(x))


class IDProjModel(nn.Module):
    def __init__(self, input_dim=512, intermediate_dim=1024, output_dim=1024):
        super().__init__()
        self.proj1 = Linear(input_dim, intermediate_dim)
        self.proj2 = Linear(intermediate_dim, intermediate_dim)
        self.proj3 = Linear(intermediate_dim, output_dim)

    def forward(self, x):
        return self.proj3(F.relu(self.proj2(F.relu(self.proj1(x)))))


class PoseGuider(nn.Module):
    """Per frame: 3x3 convs with SiLU, stride 2 between widths, then a 3x3
    conv to the UNet's first width. (B, F, H, W, 3) -> (B, F, H/8, W/8, C)."""

    def __init__(self, embedding_channels=320,
                 block_out_channels: Sequence[int] = (16, 32, 96, 256)):
        super().__init__()
        boc = block_out_channels
        self.conv_in = Conv2d(3, boc[0], 3, padding=1)
        blocks = []
        for cin, cout in zip(boc[:-1], boc[1:]):
            blocks.append(Conv2d(cin, cin, 3, padding=1))
            blocks.append(Conv2d(cin, cout, 3, stride=2, padding=1))
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = Conv2d(boc[-1], embedding_channels, 3, padding=1)

    def forward(self, x):
        b, f = x.shape[:2]
        h = F.silu(self.conv_in(x.reshape(b * f, *x.shape[2:])))
        for blk in self.blocks:
            h = F.silu(blk(h))
        h = self.conv_out(h)
        return h.reshape(b, f, *h.shape[1:])
