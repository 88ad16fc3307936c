"""ArcFace identity encoder (iResNet-50), twin of
``actalker_tpu/models/arcface.py`` (the reference's ``src/utils/arcface.py``,
``get_model('r50')``): a 112 x 112 head crop in [-1, 1] -> a 512-d identity
embedding. Block: BN -> 3x3 conv -> BN -> PReLU -> 3x3 stride conv -> BN,
with a 1x1 conv + BN shortcut; stem 3x3 conv + BN + PReLU; head BN ->
flatten -> Linear(512) -> BN1d. Layers (3, 4, 14, 3), channels 64-512.

Keyed as insightface's ``backbone.pth`` (``conv1.weight``, ``layer1.0.bn1
.running_mean``, ``features.weight``, ...). The flatten before ``fc`` is in
torch's (C, H, W) order, which the checkpoint's ``fc`` rows follow. The
BatchNorms are inference-only affines over the stored statistics; a
``num_batches_tracked`` entry of the file is a training counter and is
ignored.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from actalker_tpu_torch.models.common import Conv2dNCHW, FrozenBatchNorm, Linear


def _conv(cin, cout, k=3, stride=1):
    return Conv2dNCHW(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class IBasicBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        self.bn1 = FrozenBatchNorm(cin)
        self.conv1 = _conv(cin, planes)
        self.bn2 = FrozenBatchNorm(planes)
        self.prelu = nn.PReLU(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn3 = FrozenBatchNorm(planes)
        self.downsample = None
        if stride != 1 or cin != planes:
            self.downsample = nn.Sequential(_conv(cin, planes, 1, stride),
                                            FrozenBatchNorm(planes))

    def forward(self, x):
        out = self.bn3(self.conv2(self.prelu(self.bn2(self.conv1(self.bn1(x))))))
        return out + (x if self.downsample is None else self.downsample(x))


class IResNet(nn.Module):
    def __init__(self, layers: Sequence[int] = (3, 4, 14, 3),
                 embed_dim: int = 512, image_size: int = 112):
        super().__init__()
        self.conv1 = _conv(3, 64)
        self.bn1 = FrozenBatchNorm(64)
        self.prelu = nn.PReLU(64)
        cin, planes = 64, 64
        for i, blocks in enumerate(layers):
            setattr(self, f"layer{i + 1}", nn.Sequential(*(
                IBasicBlock(cin if j == 0 else planes, planes, 2 if j == 0 else 1)
                for j in range(blocks))))
            cin, planes = planes, planes * 2
        side = image_size // 2 ** len(layers)
        self.bn2 = FrozenBatchNorm(cin)
        self.fc = Linear(cin * side * side, embed_dim)
        self.features = FrozenBatchNorm(embed_dim)

    def forward(self, x):
        """x (N, 112, 112, 3) in [-1, 1] -> (N, 512)."""
        h = self.prelu(self.bn1(self.conv1(x.permute(0, 3, 1, 2))))
        for i in range(4):
            h = getattr(self, f"layer{i + 1}")(h)
        h = self.bn2(h).flatten(1)
        return self.features(self.fc(h))


def iresnet50() -> IResNet:
    return IResNet(layers=(3, 4, 14, 3))
