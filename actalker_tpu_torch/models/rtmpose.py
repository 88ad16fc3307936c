"""RTMPose (CSPNeXt + SimCC head), twin of ``actalker_tpu/models/rtmpose.py``
(the reference's DWPose stage 2, ``src/dwpose/wholebody.py:20-46`` with its
pre / post in ``src/dwpose/onnxpose.py``). The same class serves the
wholebody model (RTMPose-l, 133 keypoints, 288 x 384) and the face head of
``frontend/landmarks.py`` (RTMPose-m face6: widen 0.75, deepen 0.67, 106
keypoints, 256 x 256).

CSPNeXt: a stem of three 3x3 convs, four stages of a stride-2 conv, (in
the last) an SPP bottleneck, and a CSP layer of CSPNeXt blocks (3x3 conv,
depthwise-5x5 separable conv) with channel attention. The RTMCC head: a
7x7 conv, a ScaleNorm + linear MLP over the flattened map, one gated
attention unit (ScaleNorm, SiLU(uv), relu^2 attention, a gate) and the
SimCC x / y linears. Keyed as an mmpose RTMPose state dict
(``backbone.stem.N``, ``backbone.stageS.I.*``, ``head.*``), each conv a
``conv`` + ``bn`` (eps 1e-5) pair as the checkpoint has it.

Host pre / post (numpy), the reference's ``onnxpose.py``:
``bbox_xyxy2cs`` (padding 1.25), ``top_down_affine``, the SimCC argmax
decode with the min(x, y) score rule, and the centre / scale rescale.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from actalker_tpu_torch.models.common import FrozenBatchNorm

# (in, out, blocks, add_identity, use_spp) per stage, P5 arch
ARCH = ((64, 128, 3, True, False), (128, 256, 6, True, False),
        (256, 512, 6, True, False), (512, 1024, 3, False, True))


@dataclass
class RTMPoseConfig:
    """l (the DWPose wholebody model): widen / deepen 1.0; m: 0.75 / 0.67."""
    widen: float = 1.0
    deepen: float = 1.0
    num_keypoints: int = 133
    input_size: Tuple[int, int] = (288, 384)   # (w, h)
    simcc_split_ratio: float = 2.0
    gau_hidden: int = 256
    gau_s: int = 128
    gau_expansion: int = 2

    def ch(self, c: int) -> int:
        return int(c * self.widen)

    def n(self, d: int) -> int:
        return max(round(d * self.deepen), 1)


class Conv(nn.Module):
    """conv (no bias) -> BatchNorm -> SiLU (mmcv's ConvModule)."""

    def __init__(self, cin, cout, k=3, s=1, groups=1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, s, k // 2, groups=groups, bias=False)
        self.bn = FrozenBatchNorm(cout)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class DWSeparable(nn.Module):
    def __init__(self, cin, cout, k=5):
        super().__init__()
        self.depthwise_conv = Conv(cin, cin, k, groups=cin)
        self.pointwise_conv = Conv(cin, cout, 1)

    def forward(self, x):
        return self.pointwise_conv(self.depthwise_conv(x))


class CSPNeXtBlock(nn.Module):
    def __init__(self, cin, cout, add_identity=True):
        super().__init__()
        self.conv1 = Conv(cin, int(cout * 0.5), 3)
        self.conv2 = DWSeparable(int(cout * 0.5), cout, 5)
        self.add = add_identity and cin == cout

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return x + y if self.add else y


class ChannelAttention(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.fc = nn.Conv2d(c, c, 1)

    def forward(self, x):
        return x * F.hardsigmoid(self.fc(x.mean((2, 3), keepdim=True)))


class CSPLayer(nn.Module):
    def __init__(self, cin, cout, n=1, add_identity=True):
        super().__init__()
        mid = int(cout * 0.5)
        self.main_conv, self.short_conv = Conv(cin, mid, 1), Conv(cin, mid, 1)
        self.final_conv = Conv(2 * mid, cout, 1)
        self.blocks = nn.Sequential(*(CSPNeXtBlock(mid, mid, add_identity)
                                      for _ in range(n)))
        self.attention = ChannelAttention(2 * mid)

    def forward(self, x):
        y = torch.cat([self.blocks(self.main_conv(x)), self.short_conv(x)], 1)
        return self.final_conv(self.attention(y))


class SPPBottleneck(nn.Module):
    def __init__(self, cin, cout, ks=(5, 9, 13)):
        super().__init__()
        self.conv1 = Conv(cin, cin // 2, 1)
        self.conv2 = Conv(cin // 2 * (len(ks) + 1), cout, 1)
        self.ks = ks

    def forward(self, x):
        x = self.conv1(x)
        return self.conv2(torch.cat([x] + [F.max_pool2d(x, k, 1, k // 2)
                                           for k in self.ks], 1))


class ScaleNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(1))
        self.scale = dim ** -0.5

    def forward(self, x):
        norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True) * self.scale
        return x / norm.clamp_min(1e-5) * self.g


class Scale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * self.scale


class GAU(nn.Module):
    """The RTMCC gated attention unit (self-attention, no RoPE or relative
    bias): ScaleNorm -> SiLU(uv) -> relu^2 attention -> gate."""

    def __init__(self, hidden: int, s: int, expansion: int):
        super().__init__()
        e = hidden * expansion
        self.e, self.s = e, s
        self.ln = ScaleNorm(hidden)
        self.uv = nn.Linear(hidden, 2 * e + s)
        self.gamma = nn.Parameter(torch.randn(2, s) * 0.02)
        self.beta = nn.Parameter(torch.zeros(2, s))
        self.o = nn.Linear(e, hidden)
        self.res_scale = Scale(hidden)

    def forward(self, x):
        u, v, base = torch.split(F.silu(self.uv(self.ln(x))), [self.e, self.e, self.s], -1)
        q = base * self.gamma[0] + self.beta[0]
        k = base * self.gamma[1] + self.beta[1]
        kernel = torch.square(F.relu(q @ k.transpose(1, 2) / math.sqrt(self.s)))
        return self.res_scale(x) + self.o(u * (kernel @ v))


class RTMPoseNet(nn.Module):
    """(B, H, W, 3) ImageNet-normalized crops, (H, W) = ``input_size[::-1]``
    -> (simcc_x (B, K, W * ratio), simcc_y (B, K, H * ratio)), the ONNX
    model's outputs (``onnxpose.py:102-105``)."""

    def __init__(self, cfg: RTMPoseConfig = None):
        super().__init__()
        self.cfg = c = cfg or RTMPoseConfig()
        half = int(ARCH[0][0] * c.widen // 2)
        self.backbone = bb = nn.Module()
        bb.stem = nn.Sequential(Conv(3, half, 3, 2), Conv(half, half, 3),
                                Conv(half, c.ch(ARCH[0][0]), 3))
        for i, (cin, cout, nb, ident, spp) in enumerate(ARCH, start=1):
            mods = [Conv(c.ch(cin), c.ch(cout), 3, 2)]
            if spp:
                mods.append(SPPBottleneck(c.ch(cout), c.ch(cout)))
            mods.append(CSPLayer(c.ch(cout), c.ch(cout), c.n(nb), ident))
            setattr(bb, f"stage{i}", nn.Sequential(*mods))
        w, h = c.input_size
        tokens = (h // 32) * (w // 32)
        self.head = hd = nn.Module()
        hd.final_layer = nn.Conv2d(c.ch(ARCH[-1][1]), c.num_keypoints, 7, 1, 3)
        hd.mlp = nn.Sequential(ScaleNorm(tokens),
                               nn.Linear(tokens, c.gau_hidden, bias=False))
        hd.gau = GAU(c.gau_hidden, c.gau_s, c.gau_expansion)
        hd.cls_x = nn.Linear(c.gau_hidden, int(w * c.simcc_split_ratio), bias=False)
        hd.cls_y = nn.Linear(c.gau_hidden, int(h * c.simcc_split_ratio), bias=False)

    def forward(self, x):
        bb = self.backbone
        x = bb.stem(x.permute(0, 3, 1, 2))
        for i in range(1, 5):
            x = getattr(bb, f"stage{i}")(x)
        tokens = self.head.gau(self.head.mlp(self.head.final_layer(x).flatten(2)))
        return self.head.cls_x(tokens), self.head.cls_y(tokens)


# ----------------------------------------------------- host pre / post tail

MEAN = np.array([123.675, 116.28, 103.53], np.float32)
STD = np.array([58.395, 57.12, 57.375], np.float32)


def bbox_xyxy2cs(bbox: np.ndarray, padding: float = 1.25):
    """``onnxpose.py:115-146``."""
    x1, y1, x2, y2 = bbox[:4]
    center = np.array([(x1 + x2) * 0.5, (y1 + y2) * 0.5], np.float32)
    scale = np.array([(x2 - x1) * padding, (y2 - y1) * padding], np.float32)
    return center, scale


def _fix_aspect_ratio(scale: np.ndarray, aspect: float) -> np.ndarray:
    w, h = scale
    if w > h * aspect:
        return np.array([w, w / aspect], np.float32)
    return np.array([h * aspect, h], np.float32)


def get_warp_matrix(center, scale, rot_deg, output_size) -> np.ndarray:
    """``onnxpose.py:200-252``: the affine src -> dst from 3 point pairs."""
    rot = math.radians(rot_deg)
    src_w = scale[0]
    dst_w, dst_h = output_size
    sn, cs = math.sin(rot), math.cos(rot)
    src_dir = np.array([0.0 * cs - (-0.5 * src_w) * sn,
                        0.0 * sn + (-0.5 * src_w) * cs], np.float32)
    dst_dir = np.array([0.0, dst_w * -0.5], np.float32)

    def third(a, b):
        d = a - b
        return b + np.array([-d[1], d[0]], np.float32)

    src = np.zeros((3, 2), np.float32)
    src[0] = center
    src[1] = center + src_dir
    src[2] = third(src[0], src[1])
    dst = np.zeros((3, 2), np.float32)
    dst[0] = [dst_w * 0.5, dst_h * 0.5]
    dst[1] = dst[0] + dst_dir
    dst[2] = third(dst[0], dst[1])
    A = np.concatenate([src, np.ones((3, 1), np.float32)], axis=1)
    return np.linalg.solve(A, dst).T.astype(np.float32)


def warp_affine(img: np.ndarray, mat: np.ndarray,
                out_wh: Tuple[int, int]) -> np.ndarray:
    """Bilinear inverse-mapped affine warp (cv2.warpAffine semantics, zero
    outside the image)."""
    w, h = out_wh
    inv = np.linalg.inv(np.vstack([mat, [0, 0, 1]]))[:2]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    src_x = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    src_y = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
    x0 = np.clip(np.floor(src_x).astype(np.int64), 0, img.shape[1] - 2)
    y0 = np.clip(np.floor(src_y).astype(np.int64), 0, img.shape[0] - 2)
    fx = np.clip(src_x - x0, 0.0, 1.0)[..., None]
    fy = np.clip(src_y - y0, 0.0, 1.0)[..., None]
    inb = ((src_x >= 0) & (src_x <= img.shape[1] - 1)
           & (src_y >= 0) & (src_y <= img.shape[0] - 1))[..., None]
    f = img.astype(np.float32)
    out = ((f[y0, x0] * (1 - fx) + f[y0, x0 + 1] * fx) * (1 - fy)
           + (f[y0 + 1, x0] * (1 - fx) + f[y0 + 1, x0 + 1] * fx) * fy)
    return np.where(inb, out, 0.0)


def top_down_affine(input_size, scale, center, img):
    """``onnxpose.py:255-285``."""
    w, h = input_size
    scale = _fix_aspect_ratio(scale, w / h)
    mat = get_warp_matrix(center, scale, 0, (w, h))
    return warp_affine(img, mat, (int(w), int(h))), scale


def simcc_decode(simcc_x: np.ndarray, simcc_y: np.ndarray, split_ratio: float = 2.0):
    """``get_simcc_maximum`` + ``decode`` (onnxpose.py:292-351)."""
    n, k, _ = simcc_x.shape
    fx = simcc_x.reshape(n * k, -1)
    fy = simcc_y.reshape(n * k, -1)
    locs = np.stack([fx.argmax(1), fy.argmax(1)], -1).astype(np.float32)
    vals = np.minimum(fx.max(1), fy.max(1))
    locs[vals <= 0.0] = -1
    return locs.reshape(n, k, 2) / split_ratio, vals.reshape(n, k)


class RTMPoseWholebody:
    """``inference_pose`` (onnxpose.py:354-375): boxes + a BGR image ->
    (keypoints (N, K, 2) in source pixels, scores (N, K)). ``net`` runs on
    its parameters' device, in fp32."""

    def __init__(self, net: RTMPoseNet):
        self.net = net.eval()
        self.cfg = net.cfg

    @torch.no_grad()
    def __call__(self, image_bgr: np.ndarray, bboxes: Sequence):
        w, h = self.cfg.input_size
        if len(bboxes) == 0:
            bboxes = [[0, 0, image_bgr.shape[1], image_bgr.shape[0]]]
        dev = next(self.net.parameters()).device
        keypoints, scores = [], []
        for bbox in bboxes:
            center, scale = bbox_xyxy2cs(np.asarray(bbox, np.float32))
            crop, scale = top_down_affine((w, h), scale, center, image_bgr)
            x = torch.from_numpy(((crop - MEAN) / STD).astype(np.float32))[None]
            sx, sy = (t.float().cpu().numpy() for t in self.net(x.to(dev)))
            kpts, sc = simcc_decode(sx, sy, self.cfg.simcc_split_ratio)
            keypoints.append((kpts / np.array([w, h]) * scale + center - scale / 2)[0])
            scores.append(sc[0])
        return np.stack(keypoints), np.stack(scores)
