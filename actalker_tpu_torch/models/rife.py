"""RIFE (IFNet-HDv3) frame interpolation, twin of
``actalker_tpu/models/rife.py`` (the reference's ``src/utils/RIFE/
IFNet_HDv3.py`` + ``RIFE_HDv3.py``): three coarse-to-fine IFBlocks (c = 90)
run on (img0, img1) and (img1, img0), the forward and backward flow
estimates averaged; the images are backward-warped by the accumulated flow
and blended by a sigmoid mask. ``interpolate_pairs`` doubles the frame
rate (the reference's ``Inference.py:344-355``).

Keyed as ``flownet.pkl`` without its ``module.`` prefix:
``block{i}.conv0.{0,1}.{0,1}`` (conv, PReLU), ``block{i}.convblock{j}.
{0,1}.{0,1}``, ``block{i}.conv{1,2}.{0,1,2}`` (ConvTranspose2d(4, 2, 1),
PReLU, ConvTranspose2d(4, 2, 1)). The transposed convs take the
checkpoint's kernels as they are; the JAX package's ``convert_rife`` copies
them into flax's ConvTranspose without the flip torch's transposed conv
implies (``io/jax_export.py``, kind ``convT_flip``).

Resizes shrink with antialiasing, as ``jax.image.resize`` does (the
reference's torch RIFE may not: not checked, the reference tree being
absent). Frames are NHWC in [0, 1] at the boundary, NCHW inside.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


def _conv(cin: int, cout: int, stride: int = 1) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, 3, stride, 1), nn.PReLU(cout))


def _resize(x, hw):
    if tuple(x.shape[-2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=hw, mode="bilinear", align_corners=False,
                         antialias=True)


def warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward warp of img (N, C, H, W) by flow (N, 2, H, W) in pixels:
    bilinear, the sample points clamped to the border (the reference's
    ``warplayer.py:7-22``)."""
    n, _, h, w = img.shape
    ys = torch.linspace(-1.0, 1.0, h, device=img.device, dtype=img.dtype)
    xs = torch.linspace(-1.0, 1.0, w, device=img.device, dtype=img.dtype)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    grid = torch.stack([gx + flow[:, 0] / ((w - 1.0) / 2.0),
                        gy + flow[:, 1] / ((h - 1.0) / 2.0)], -1)
    return F.grid_sample(img, grid, mode="bilinear", padding_mode="border",
                         align_corners=True)


class IFBlock(nn.Module):
    def __init__(self, cin: int, c: int = 90):
        super().__init__()
        self.conv0 = nn.Sequential(_conv(cin, c // 2, 2), _conv(c // 2, c, 2))
        for i in range(4):
            setattr(self, f"convblock{i}", nn.Sequential(_conv(c, c), _conv(c, c)))
        for name, cout in (("conv1", 4), ("conv2", 1)):
            setattr(self, name, nn.Sequential(
                nn.ConvTranspose2d(c, c // 2, 4, 2, 1), nn.PReLU(c // 2),
                nn.ConvTranspose2d(c // 2, cout, 4, 2, 1)))

    def forward(self, x, flow, scale: float):
        h, w = x.shape[-2:]
        sh, sw = int(h / scale), int(w / scale)
        x = _resize(x, (sh, sw))
        flow = _resize(flow, (sh, sw)) / scale
        feat = self.conv0(torch.cat([x, flow], 1))
        for i in range(4):
            feat = feat + getattr(self, f"convblock{i}")(feat)
        flow_out = _resize(self.conv1(feat), (h, w)) * scale
        mask_out = _resize(self.conv2(feat), (h, w))
        return flow_out, mask_out


class IFNet(nn.Module):
    """(img0, img1) (N, H, W, 3) in [0, 1] -> their midpoint frame."""

    def __init__(self, c: int = 90):
        super().__init__()
        for i in range(3):
            setattr(self, f"block{i}", IFBlock(3 + 3 + 1 + 4, c))

    def forward(self, img0, img1, scale_list: Sequence[float] = (4.0, 2.0, 1.0)):
        img0, img1 = img0.permute(0, 3, 1, 2), img1.permute(0, 3, 1, 2)
        n, _, h, w = img0.shape
        flow = img0.new_zeros(n, 4, h, w)
        mask = img0.new_zeros(n, 1, h, w)
        warped0, warped1 = img0, img1
        for i, scale in enumerate(scale_list):
            blk = getattr(self, f"block{i}")
            f0, m0 = blk(torch.cat([warped0, warped1, mask], 1), flow, scale)
            f1, m1 = blk(torch.cat([warped1, warped0, -mask], 1),
                         torch.cat([flow[:, 2:4], flow[:, :2]], 1), scale)
            flow = flow + (f0 + torch.cat([f1[:, 2:4], f1[:, :2]], 1)) / 2
            mask = mask + (m0 - m1) / 2
            warped0 = warp(img0, flow[:, :2])
            warped1 = warp(img1, flow[:, 2:4])
        m = torch.sigmoid(mask)
        return (warped0 * m + warped1 * (1 - m)).permute(0, 2, 3, 1)


def interpolate_pairs(net: IFNet, frames: torch.Tensor) -> torch.Tensor:
    """(F, H, W, 3) -> (2F - 1, H, W, 3): the midpoint of every pair,
    clipped to [0, 1], inserted between them."""
    mids = net(frames[:-1], frames[1:]).clamp(0, 1)
    out = frames.new_empty((2 * frames.shape[0] - 1,) + tuple(frames.shape[1:]))
    out[0::2] = frames
    out[1::2] = mids
    return out
