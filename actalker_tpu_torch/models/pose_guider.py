"""PoseGuider: frame-wise 3x3 conv stack (16/32/96/256, stride-2 between
scales) ending in a zero-initialized conv to the UNet's first width. Twin of
``actalker_tpu/models/pose_guider.py``; input (B, F, H, W, 3) in [0, 1]."""
from __future__ import annotations

from typing import Tuple

import torch.nn as nn
import torch.nn.functional as F

from actalker_tpu_torch.models.common import Conv2d


class PoseGuider(nn.Module):
    def __init__(self, embedding_channels: int = 320,
                 block_out_channels: Tuple[int, ...] = (16, 32, 96, 256)):
        super().__init__()
        boc = block_out_channels
        self.conv_in = Conv2d(3, boc[0], 3, padding=1)
        blocks = []
        for cin, cout in zip(boc[:-1], boc[1:]):
            blocks.append(Conv2d(cin, cin, 3, padding=1))
            blocks.append(Conv2d(cin, cout, 3, stride=2, padding=1))
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = Conv2d(boc[-1], embedding_channels, 3, padding=1)
        nn.init.zeros_(self.conv_out.weight)
        nn.init.zeros_(self.conv_out.bias)

    def forward(self, x):
        b, f = x.shape[:2]
        h = F.silu(self.conv_in(x.reshape(b * f, *x.shape[2:])))
        for blk in self.blocks:
            h = F.silu(blk(h))
        h = self.conv_out(h)
        return h.reshape(b, f, *h.shape[1:])
