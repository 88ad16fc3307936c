"""SENet-50 face embedder (VGGFace2) for identity evaluation, twin of
``actalker_tpu/models/senet.py``.

The reference's face-ID score embeds face crops with a VGGFace2 SENet-50
(``eval/evaluation_faceid.py:18,33-55``; its ``modules.model.senet`` is
absent from the reference repo) and reports the cosine of the 2048-d
pooled features. The graph is the JAX twin's: conv7x7/2 + BN + relu +
max-pool 3/2 (ceil mode), stages [3, 4, 6, 3] of SE bottlenecks (1x1 ->
3x3 (the stride) -> 1x1, squeeze-excite gate of reduction 16 on 1x1 convs
with bias), global average pool. Keys are the ones
``io/weights.py::convert_senet50`` reads: ``conv1`` / ``bn1``,
``layer{i}.{j}.conv{k}`` / ``bn{k}``, ``se_module.fc1`` / ``fc2``,
``downsample.0`` / ``.1`` and the 8631-way ``fc`` (kept for the file;
``include_top`` returns its logits too). NCHW, fp32, BatchNorm eps 1e-5.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# RGB means of the VGGFace2 training recipe (subtracted on 224 x 224 crops)
VGGFACE2_MEAN_RGB = (131.0912, 103.8827, 91.4953)


class _SEModule(nn.Module):
    def __init__(self, ch: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Conv2d(ch, ch // reduction, 1)
        self.fc2 = nn.Conv2d(ch // reduction, ch, 1)

    def forward(self, x):
        s = x.mean((2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc2(F.relu(self.fc1(s))))


class SEBottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.se_module = _SEModule(planes * 4)
        self.downsample = nn.Sequential(
            nn.Conv2d(cin, planes * 4, 1, stride, bias=False),
            nn.BatchNorm2d(planes * 4)) if downsample else None

    def forward(self, x):
        r = x if self.downsample is None else self.downsample(x)
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        return F.relu(self.se_module(h) + r)


class SENet50(nn.Module):
    """(N, 3, 224, 224) RGB [0, 255] mean-subtracted -> (N, 2048)
    embedding (``include_top``: also the 8631-way logits)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 num_classes: int = 8631, include_top: bool = False):
        super().__init__()
        self.include_top = include_top
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        cin, planes = 64, 64
        for i, blocks in enumerate(layers):
            stage = []
            for j in range(blocks):
                stage.append(SEBottleneck(cin, planes, 2 if (i > 0 and j == 0) else 1,
                                          downsample=(j == 0)))
                cin = planes * 4
            setattr(self, f"layer{i + 1}", nn.Sequential(*stage))
            planes *= 2
        self.n_layers = len(layers)
        self.fc = nn.Linear(cin, num_classes)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.max_pool2d(h, 3, 2, ceil_mode=True)   # caffe-style pool
        for i in range(self.n_layers):
            h = getattr(self, f"layer{i + 1}")(h)
        feat = h.mean((2, 3))
        return (feat, self.fc(feat)) if self.include_top else feat


def preprocess_vggface2(images: np.ndarray) -> np.ndarray:
    """(N, H, W, 3) uint8 / float RGB -> mean-subtracted fp32."""
    return np.asarray(images, np.float32) - np.asarray(VGGFACE2_MEAN_RGB, np.float32)
