"""VASA facial expression and head-pose encoders, twin of
``actalker_tpu/models/vasa.py`` (the reference's
``src/dataset/vasa_feature_v2.py``):

  * ``HeadExpression`` (107-121): ResNet-50 with GroupNorm(1) -> a 512-d
    expression code;
  * ``HeadPose`` (``HeadPose_train``, 9-22): ResNet-18 with GroupNorm(32)
    -> rotation = sigmoid * 360 - 180 (degrees), translation = sigmoid * 4
    - 2.

Both take (N, 256, 256, 3) crops (channel-last, as the JAX package) and run
their convs in NCHW. They are keyed as the MX31c checkpoint's dicts:
``HeadExpression`` as the ``generator`` entries under ``expression_model.``
(``resnet50.conv1.weight``, ...), ``HeadPose`` as ``pose_model``
(``head_pose_net.conv1.weight``, ...). Their GroupNorms are the plain
``F.group_norm`` in fp32 (flax's ``nn.GroupNorm`` in the JAX package, no
kernel there).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from actalker_tpu_torch.models.common import Conv2dNCHW, Linear


class GroupNormF32(nn.GroupNorm):
    """GroupNorm over NCHW, statistics and affine in fp32."""

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


def _conv(cin, cout, k=3, stride=1):
    return Conv2dNCHW(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1, groups: int = 1):
        super().__init__()
        out = planes * 4
        self.conv1, self.gn1 = _conv(cin, planes, 1), GroupNormF32(groups, planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.gn2 = GroupNormF32(groups, planes)
        self.conv3, self.gn3 = _conv(planes, out, 1), GroupNormF32(groups, out)
        self.downsample = None
        if stride != 1 or cin != out:
            self.downsample = nn.Sequential(_conv(cin, out, 1, stride),
                                            GroupNormF32(groups, out))

    def forward(self, x):
        h = F.relu(self.gn1(self.conv1(x)))
        h = F.relu(self.gn2(self.conv2(h)))
        h = self.gn3(self.conv3(h))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(h + res)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1, self.bn1 = _conv(cin, planes, 3, stride), GroupNormF32(32, planes)
        self.conv2, self.bn2 = _conv(planes, planes), GroupNormF32(32, planes)
        self.shortcut = None
        if stride != 1 or cin != planes:
            self.shortcut = nn.Sequential(_conv(cin, planes, 1, stride),
                                          GroupNormF32(32, planes))

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        res = x if self.shortcut is None else self.shortcut(x)
        return F.relu(h + res)


class _ResNet(nn.Module):
    """conv 7x7 / 2 -> norm -> ReLU -> max-pool 3x3 / 2 -> four stages ->
    global average -> fc."""

    def __init__(self, block, layers: Sequence[int], stem_norm: str,
                 stem_groups: int, out_dim: int, expansion: int, **kw):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, 2)
        setattr(self, stem_norm, GroupNormF32(stem_groups, 64))
        self._stem_norm = stem_norm
        cin, planes = 64, 64
        for i, blocks in enumerate(layers):
            mods = []
            for j in range(blocks):
                mods.append(block(cin, planes, 2 if (i > 0 and j == 0) else 1,
                                  **kw))
                cin = planes * expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*mods))
            planes *= 2
        self.fc = Linear(cin, out_dim)

    def forward(self, x):
        h = F.relu(getattr(self, self._stem_norm)(self.conv1(x)))
        h = F.max_pool2d(h, 3, 2, padding=1)
        for i in range(4):
            h = getattr(self, f"layer{i + 1}")(h)
        return self.fc(h.mean(dim=(2, 3)))


class HeadExpression(nn.Module):
    """ResNet-50-GN(1) -> ``out_dim`` expression code; input (N, 256, 256,
    3) in [0, 1]."""

    def __init__(self, out_dim: int = 512, layers: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.resnet50 = _ResNet(Bottleneck, layers, "gn1", 1, out_dim, 4,
                                groups=1)

    def forward(self, x):
        return self.resnet50(x.permute(0, 3, 1, 2))


class HeadPose(nn.Module):
    """ResNet-18-GN(32) -> {"rotation": (N, 3) degrees, "translation":
    (N, 3)}; input (N, 256, 256, 3) in [-1, 1]."""

    def __init__(self, layers: Sequence[int] = (2, 2, 2, 2)):
        super().__init__()
        self.head_pose_net = _ResNet(BasicBlock, layers, "bn1", 32, 6, 1)

    def forward(self, x):
        out = self.head_pose_net(x.permute(0, 3, 1, 2))
        return {"rotation": torch.sigmoid(out[:, :3]) * 360.0 - 180.0,
                "translation": torch.sigmoid(out[:, 3:]) * 4.0 - 2.0}
