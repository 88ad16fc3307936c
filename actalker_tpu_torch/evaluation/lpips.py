"""LPIPS perceptual distance, AlexNet variant: twin of
``actalker_tpu/evaluation/lpips.py`` and keyed as the ``lpips`` package's
``LPIPS(net='alex')`` state dict (the reference's
``utils/image_level_evaluation.py:12-50``): ``scaling_layer.shift`` /
``scale``, the AlexNet features under ``net.slice1.0`` ... ``net.slice5.10``
(torchvision's ``features`` indices 0 / 3 / 6 / 8 / 10) and the 1x1 heads
under ``lin0.model.1`` ... ``lin4.model.1`` (also reachable as
``lins.K``, as in the package).

Forward, inputs (B, 3, H, W) in [-1, 1]: whiten with the scaling layer,
five AlexNet stages (relu outputs), unit-normalize each over channels
(``x / (||x|| + 1e-10)``, the package's ``normalize_tensor``; the JAX twin
puts the eps under the root, below fp32 rounding here), squared
difference, 1x1 head, spatial mean, summed over stages.
"""
from __future__ import annotations

import torch
import torch.nn as nn

# (in, out, kernel, stride, pad) of AlexNet's five convs, and where each
# sits in torchvision's ``features`` (the lpips slices keep those indices)
_CONVS = ((3, 64, 11, 4, 2), (64, 192, 5, 1, 2), (192, 384, 3, 1, 1),
          (384, 256, 3, 1, 1), (256, 256, 3, 1, 1))
_FEATURE_IDX = (0, 3, 6, 8, 10)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class _ScalingLayer(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("shift", torch.tensor(_SHIFT)[None, :, None, None])
        self.register_buffer("scale", torch.tensor(_SCALE)[None, :, None, None])

    def forward(self, x):
        return (x - self.shift) / self.scale


class _AlexSlices(nn.Module):
    """torchvision AlexNet ``features`` cut after each relu: slice k holds
    the k-th conv (with the max-pool before it for slices 2 and 3)."""

    def __init__(self):
        super().__init__()
        for k, ((ci, co, ks, st, pd), idx) in enumerate(zip(_CONVS, _FEATURE_IDX)):
            s = nn.Sequential()
            if k in (1, 2):
                s.add_module(str(idx - 1), nn.MaxPool2d(kernel_size=3, stride=2))
            s.add_module(str(idx), nn.Conv2d(ci, co, ks, st, pd))
            s.add_module(str(idx + 1), nn.ReLU())
            setattr(self, f"slice{k + 1}", s)

    def forward(self, x):
        outs = []
        for k in range(5):
            x = getattr(self, f"slice{k + 1}")(x)
            outs.append(x)
        return outs


class _NetLinLayer(nn.Module):
    def __init__(self, chn_in: int):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(), nn.Conv2d(chn_in, 1, 1, bias=False))

    def forward(self, x):
        return self.model(x)


class LPIPSAlex(nn.Module):
    """Per-pair LPIPS distances (B,) of two (B, 3, H, W) batches in [-1, 1]."""

    def __init__(self):
        super().__init__()
        self.scaling_layer = _ScalingLayer()
        self.net = _AlexSlices()
        for k, (_, co, *_) in enumerate(_CONVS):
            setattr(self, f"lin{k}", _NetLinLayer(co))
        self.lins = nn.ModuleList([getattr(self, f"lin{k}") for k in range(5)])

    def forward(self, x, y):
        fx = self.net(self.scaling_layer(x))
        fy = self.net(self.scaling_layer(y))
        total = 0.0
        for lin, a, b in zip(self.lins, fx, fy):
            a = a / (a.square().sum(1, keepdim=True).sqrt() + 1e-10)
            b = b / (b.square().sum(1, keepdim=True).sqrt() + 1e-10)
            total = total + lin((a - b) ** 2).mean(dim=(2, 3))[:, 0]
        return total


def lpips_distance(net: LPIPSAlex, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """LPIPS over (B, H, W, 3) pairs in [-1, 1] (the JAX entry's layout)."""
    with torch.no_grad():
        return net(x.permute(0, 3, 1, 2).float(), y.permute(0, 3, 1, 2).float())
