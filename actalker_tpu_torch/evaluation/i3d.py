"""I3D (Inception-v1 3D) video feature extractor for FVD, twin of
``actalker_tpu/evaluation/i3d.py``, keyed as the reference's
``pytorch_i3d.InceptionI3d`` state dict (``rgb_charades.pt``:
``<endpoint>.conv3d`` + ``.bn`` (eps 1e-3) per ``Unit3D``, the inception
branches ``b0`` / ``b1a`` / ``b1b`` / ``b2a`` / ``b2b`` / ``b3b``, the
157-way ``logits`` conv kept for the file).

``Unit3D`` and ``MaxPool3dSamePadding`` pad as TF SAME by hand
(``pytorch_i3d.py:13-45,82-113``): zeros, front half rounded down; the
pools see relu outputs, so zero padding is the -inf of the JAX twin's
SAME. ``extract_features`` = through Mixed_5c, then the (2, 7, 7) / 1
average pool (``pytorch_i3d.py:334-338``); the FVD driver feeds 224 x 224
RGB in [0, 1] (``utils/video_level_evaluation.py:101-126``) and averages
the rest over time and space. NCTHW, fp32.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# InceptionModule output channels: (b0, b1a, b1b, b2a, b2b, b3b)
_MIXED = {
    "Mixed_3b": (192, (64, 96, 128, 16, 32, 32)),
    "Mixed_3c": (256, (128, 128, 192, 32, 96, 64)),
    "Mixed_4b": (480, (192, 96, 208, 16, 48, 64)),
    "Mixed_4c": (512, (160, 112, 224, 24, 64, 64)),
    "Mixed_4d": (512, (128, 128, 256, 24, 64, 64)),
    "Mixed_4e": (512, (112, 144, 288, 32, 64, 64)),
    "Mixed_4f": (528, (256, 160, 320, 32, 128, 128)),
    "Mixed_5b": (832, (256, 160, 320, 32, 128, 128)),
    "Mixed_5c": (832, (384, 192, 384, 48, 128, 128)),
}


def _same_pad(x, kernel, stride):
    """TF SAME zero padding of the last three axes (``compute_pad``)."""
    pads = []
    for dim in (2, 1, 0):          # F.pad runs from the last axis
        s, k, st = x.shape[2 + dim], kernel[dim], stride[dim]
        p = max(k - (st if s % st == 0 else s % st), 0)
        pads += [p // 2, p - p // 2]
    return F.pad(x, pads)


class Unit3D(nn.Module):
    def __init__(self, cin: int, cout: int, kernel=(1, 1, 1), stride=(1, 1, 1),
                 bn: bool = True, relu: bool = True, bias: bool = False):
        super().__init__()
        self.kernel, self.stride, self.relu = tuple(kernel), tuple(stride), relu
        self.conv3d = nn.Conv3d(cin, cout, self.kernel, self.stride, bias=bias)
        self.bn = nn.BatchNorm3d(cout, eps=0.001) if bn else None

    def forward(self, x):
        x = self.conv3d(_same_pad(x, self.kernel, self.stride))
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.relu else x


def _max_pool_same(x, kernel, stride):
    return F.max_pool3d(_same_pad(x, kernel, stride), kernel, stride)


class InceptionModule(nn.Module):
    def __init__(self, cin: int, c: Sequence[int]):
        super().__init__()
        k3 = (3, 3, 3)
        self.b0 = Unit3D(cin, c[0])
        self.b1a = Unit3D(cin, c[1])
        self.b1b = Unit3D(c[1], c[2], k3)
        self.b2a = Unit3D(cin, c[3])
        self.b2b = Unit3D(c[3], c[4], k3)
        self.b3b = Unit3D(cin, c[5])

    def forward(self, x):
        return torch.cat([
            self.b0(x), self.b1b(self.b1a(x)), self.b2b(self.b2a(x)),
            self.b3b(_max_pool_same(x, (3, 3, 3), (1, 1, 1)))], 1)


# the endpoints in order: a name, or a max-pool (kernel, stride)
_ENDPOINTS = (
    "Conv3d_1a_7x7", ((1, 3, 3), (1, 2, 2)), "Conv3d_2b_1x1", "Conv3d_2c_3x3",
    ((1, 3, 3), (1, 2, 2)), "Mixed_3b", "Mixed_3c", ((3, 3, 3), (2, 2, 2)),
    "Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f",
    ((2, 2, 2), (2, 2, 2)), "Mixed_5b", "Mixed_5c")


class InceptionI3D(nn.Module):
    """``extract_features``: (B, 3, T, H, W) in [0, 1] -> the pooled
    (B, 1024, T', H', W') maps."""

    def __init__(self, num_classes: int = 157):
        super().__init__()
        self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2))
        self.Conv3d_2b_1x1 = Unit3D(64, 64)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3))
        for name, (cin, c) in _MIXED.items():
            setattr(self, name, InceptionModule(cin, c))
        self.logits = Unit3D(1024, num_classes, bn=False, relu=False, bias=True)

    def forward(self, x):
        for ep in _ENDPOINTS:
            x = _max_pool_same(x, *ep) if isinstance(ep, tuple) else getattr(self, ep)(x)
        return F.avg_pool3d(x, (2, 7, 7), stride=1)


def i3d_feature_fn(net: InceptionI3D):
    """``(B, T, 224, 224, 3) float [0, 1] numpy -> (B, 1024)`` for
    ``metrics.fvd`` on ``net``'s device (averaged over the rest of time
    and space)."""
    dev = next(net.parameters()).device

    @torch.no_grad()
    def fn(clips: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.asarray(clips, np.float32)).to(dev)
        return net(x.permute(0, 4, 1, 2, 3)).mean((2, 3, 4)).cpu().numpy()

    return fn
