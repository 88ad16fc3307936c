"""SCRFD face detector with 5-point landmarks, twin of
``actalker_tpu/models/scrfd.py`` (the reference's alternate face stage,
``src/utils/face_align/scrfd.py``, which ships only compiled graphs): the
public insightface SCRFD-10G-bnkps network — a ResNetV1e backbone (deep
3x3 stem, avg-pool shortcuts, BasicBlocks (3, 4, 2, 3) of widths (56, 88,
88, 224)), a PAFPN neck (56 channels, strides 8 / 16 / 32) and a head of
four shared 3x3 conv + GroupNorm(16) blocks with per-stride cls (2) / bbox
(8) / kps (20) convs — and the reference's host tail: the keep-ratio
letterbox (``scrfd.py:151-169``), the anchor-centre decode
(``distance2bbox`` / ``distance2kps``, :193-214), the rescale to source
pixels and NMS (:254-268).

Keyed as an mmdet-style SCRFD state dict (``backbone.stem.{0,1,3,4,6,7}``,
``backbone.layerN.M.{conv,bn}{1,2}`` / ``.downsample.*``,
``neck.{lateral,fpn,downsample,pafpn}_convs.N.{conv,bn}``,
``bbox_head.cls_convs.N.{conv,gn}``, ``bbox_head.stride_{cls,reg,kps}.N``).
The convs keep their BatchNorms (eps 1e-5) as the checkpoint has them; the
JAX package folds them at conversion.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from actalker_tpu_torch.models.common import FrozenBatchNorm
from actalker_tpu_torch.models.yoloface import best_box, nms_xyxy

STRIDES = (8, 16, 32)


@dataclass
class ScrfdConfig:
    """SCRFD-10G-bnkps, the checkpoint family the reference names
    (``scrfd.py:8-10``)."""
    stage_blocks: Tuple[int, ...] = (3, 4, 2, 3)
    stage_planes: Tuple[int, ...] = (56, 88, 88, 224)
    stem_channels: int = 28
    neck_channels: int = 56
    head_channels: int = 80
    stacked_convs: int = 4
    num_anchors: int = 2
    gn_groups: int = 16

    def micro(self) -> "ScrfdConfig":
        return replace(self, stage_blocks=(1, 1, 1, 1), stage_planes=(8, 16, 16, 32),
                       stem_channels=4, neck_channels=16, head_channels=16,
                       stacked_convs=2, gn_groups=4)


class ConvBN(nn.Module):
    """conv (no bias) -> BatchNorm [-> ReLU] (mmdet's ConvModule)."""

    def __init__(self, cin, cout, k=3, s=1, relu=True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, s, k // 2, bias=False)
        self.bn = FrozenBatchNorm(cout)
        self.relu = relu

    def forward(self, x):
        y = self.bn(self.conv(x))
        return F.relu(y) if self.relu else y


class BasicBlock(nn.Module):
    """Two 3x3 convs; a stride-2 shortcut is avg-pool(2) -> 1x1 conv -> BN
    (ResNetV1e), a widening one 1x1 conv -> BN."""

    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = FrozenBatchNorm(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = FrozenBatchNorm(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            proj = [nn.Conv2d(cin, cout, 1, bias=False), FrozenBatchNorm(cout)]
            self.downsample = nn.Sequential(
                *([nn.AvgPool2d(2, 2)] if stride != 1 else []), *proj)

    def forward(self, x):
        y = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        return F.relu((x if self.downsample is None else self.downsample(x)) + y)


class GNConv(nn.Module):
    def __init__(self, cin, cout, groups):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, 1, 1, bias=False)
        self.gn = nn.GroupNorm(groups, cout)

    def forward(self, x):
        return F.relu(self.gn(self.conv(x)))


class ScrfdNet(nn.Module):
    """(B, H, W, 3) in ``x / 127.5 - 1`` (RGB) -> per stride (8, 16, 32):
    (scores (B, H*W*A, 1) after the sigmoid, bbox (B, H*W*A, 4),
    kps (B, H*W*A, 10)) in stride units, the layout of the reference's
    permuted outputs (``scrfd.py:224-233``)."""

    def __init__(self, cfg: ScrfdConfig = None):
        super().__init__()
        self.cfg = c = cfg or ScrfdConfig()
        cs, p0 = c.stem_channels, c.stage_planes[0]
        self.backbone = nn.Module()
        self.backbone.stem = nn.Sequential(
            nn.Conv2d(3, cs, 3, 2, 1, bias=False), FrozenBatchNorm(cs), nn.ReLU(),
            nn.Conv2d(cs, cs, 3, 1, 1, bias=False), FrozenBatchNorm(cs), nn.ReLU(),
            nn.Conv2d(cs, p0, 3, 1, 1, bias=False), FrozenBatchNorm(p0), nn.ReLU())
        cin = p0
        for si, (blocks, planes) in enumerate(zip(c.stage_blocks, c.stage_planes)):
            layer = []
            for bi in range(blocks):
                layer.append(BasicBlock(cin, planes, 2 if bi == 0 and si > 0 else 1))
                cin = planes
            setattr(self.backbone, f"layer{si + 1}", nn.Sequential(*layer))
        nc = c.neck_channels
        self.neck = nn.Module()
        self.neck.lateral_convs = nn.ModuleList(
            ConvBN(p, nc, 1, relu=False) for p in c.stage_planes[1:])
        self.neck.fpn_convs = nn.ModuleList(ConvBN(nc, nc, 3, relu=False) for _ in range(3))
        self.neck.downsample_convs = nn.ModuleList(
            ConvBN(nc, nc, 3, 2, relu=False) for _ in range(2))
        self.neck.pafpn_convs = nn.ModuleList(ConvBN(nc, nc, 3, relu=False) for _ in range(2))
        hc, a = c.head_channels, c.num_anchors
        self.bbox_head = nn.Module()
        self.bbox_head.cls_convs = nn.ModuleList(
            GNConv(nc if j == 0 else hc, hc, c.gn_groups) for j in range(c.stacked_convs))
        for name, per in (("stride_cls", 1), ("stride_reg", 4), ("stride_kps", 10)):
            setattr(self.bbox_head, name, nn.ModuleList(
                nn.Conv2d(hc, per * a, 3, 1, 1) for _ in STRIDES))

    def forward(self, x) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        bb, neck, head = self.backbone, self.neck, self.bbox_head
        x = F.max_pool2d(bb.stem(x.permute(0, 3, 1, 2)), 3, 2, 1)
        feats = []
        for si in range(4):
            x = getattr(bb, f"layer{si + 1}")(x)
            feats.append(x)
        lat = [conv(f) for conv, f in zip(neck.lateral_convs, feats[1:])]
        for i in range(len(lat) - 1, 0, -1):
            lat[i - 1] = lat[i - 1] + F.interpolate(
                lat[i], size=lat[i - 1].shape[-2:], mode="nearest-exact")
        inter = [conv(l) for conv, l in zip(neck.fpn_convs, lat)]
        outs = [inter[0]]
        for i in range(2):
            outs.append(neck.pafpn_convs[i](inter[i + 1] + neck.downsample_convs[i](outs[-1])))
        res = []
        for i, f in enumerate(outs):
            for conv in head.cls_convs:
                f = conv(f)
            b, _, hh, ww = f.shape
            maps = (torch.sigmoid(head.stride_cls[i](f)), head.stride_reg[i](f),
                    head.stride_kps[i](f))
            res.append(tuple(m.permute(0, 2, 3, 1).reshape(b, hh * ww * self.cfg.num_anchors, -1)
                             for m in maps))
        return res


def cv_bilinear_resize(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """cv2.resize's default (bilinear, half-pixel centres) for uint8 HWC, in
    numpy: the letterbox resampler of the reference's SCRFD path."""
    h, w = img.shape[:2]
    ys = (np.arange(oh) + 0.5) * h / oh - 0.5
    xs = (np.arange(ow) + 0.5) * w / ow - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1, x1 = np.clip(y0 + 1, 0, h - 1), np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None, None]
    wx = np.clip(xs - x0, 0, 1)[None, :, None]
    f = img.astype(np.float32)
    top = f[y0][:, x0] * (1 - wx) + f[y0][:, x1] * wx
    bot = f[y1][:, x0] * (1 - wx) + f[y1][:, x1] * wx
    return np.clip(np.round(top * (1 - wy) + bot * wy), 0, 255).astype(np.uint8)


def resize_image_keep_ratio(srcimg: np.ndarray, inp_h: int = 640, inp_w: int = 640):
    """``SCRFD.resize_image`` (scrfd.py:151-169): fit into inp_h x inp_w
    keeping the aspect, zero-padded about the centre."""
    padh, padw, newh, neww = 0, 0, inp_h, inp_w
    h, w = srcimg.shape[:2]
    img = np.zeros((inp_h, inp_w, 3), dtype=np.uint8)
    if h != w:
        hw_scale = h / w
        if hw_scale > 1:
            newh, neww = inp_h, int(inp_w / hw_scale)
            padw = int((inp_w - neww) * 0.5)
        else:
            newh, neww = int(inp_h * hw_scale) + 1, inp_w
            padh = int((inp_h - newh) * 0.5)
    img[padh:padh + newh, padw:padw + neww] = cv_bilinear_resize(srcimg, newh, neww)
    return img, newh, neww, padh, padw


def distance2bbox(points: np.ndarray, distance: np.ndarray) -> np.ndarray:
    """scrfd.py:193-203 (no clamping on the inference path)."""
    return np.stack([points[:, 0] - distance[:, 0], points[:, 1] - distance[:, 1],
                     points[:, 0] + distance[:, 2], points[:, 1] + distance[:, 3]], -1)


def distance2kps(points: np.ndarray, distance: np.ndarray) -> np.ndarray:
    """scrfd.py:204-214."""
    preds = []
    for i in range(0, distance.shape[1], 2):
        preds.append(points[:, i % 2] + distance[:, i])
        preds.append(points[:, i % 2 + 1] + distance[:, i + 1])
    return np.stack(preds, axis=-1)


def anchor_centers(height: int, width: int, stride: int,
                   num_anchors: int = 2) -> np.ndarray:
    """scrfd.py:236-239: (H*W*A, 2) pixel centres, x-major mgrid order."""
    ac = np.stack(np.mgrid[:height, :width][::-1], axis=-1).astype(np.float32)
    ac = (ac * stride).reshape(-1, 2)
    if num_anchors > 1:
        ac = np.stack([ac] * num_anchors, axis=1).reshape(-1, 2)
    return ac


def decode_scrfd(outs, input_size: int, num_anchors: int, conf_thres: float,
                 nms_thres: float, src_hw: Tuple[int, int], newh: int, neww: int,
                 padh: int, padw: int):
    """One image's per-stride (scores (N,), bbox (N, 4), kps (N, 10)) maps
    -> (bboxes (K, 4) [x, y, w, h] in source pixels, kpss (K, 5, 2),
    scores (K,)) (scrfd.py:224-268)."""
    scores_l, bboxes_l, kpss_l = [], [], []
    for (scores, bbox_p, kps_p), stride in zip(outs, STRIDES):
        ac = anchor_centers(input_size // stride, input_size // stride, stride,
                            num_anchors)
        pos = np.where(scores >= conf_thres)[0]
        scores_l.append(scores[pos])
        bboxes_l.append(distance2bbox(ac, bbox_p * stride)[pos])
        kpss_l.append(distance2kps(ac, kps_p * stride).reshape(len(ac), -1, 2)[pos])
    scores = np.concatenate(scores_l)
    if len(scores) == 0:
        return np.zeros((0, 4)), np.zeros((0, 5, 2)), np.zeros((0,))
    bboxes, kpss = np.concatenate(bboxes_l), np.concatenate(kpss_l)
    bboxes[:, 2:4] -= bboxes[:, 0:2]
    ratioh, ratiow = src_hw[0] / newh, src_hw[1] / neww
    bboxes[:, 0] = (bboxes[:, 0] - padw) * ratiow
    bboxes[:, 1] = (bboxes[:, 1] - padh) * ratioh
    bboxes[:, 2] *= ratiow
    bboxes[:, 3] *= ratioh
    kpss[:, :, 0] = (kpss[:, :, 0] - padw) * ratiow
    kpss[:, :, 1] = (kpss[:, :, 1] - padh) * ratioh
    xyxy = np.concatenate([bboxes[:, :2], bboxes[:, :2] + bboxes[:, 2:4]], 1)
    keep = nms_xyxy(xyxy, scores, nms_thres)
    return bboxes[keep], kpss[keep], scores[keep]


class ScrfdDetector:
    """The reference's ``SCRFD.detect`` (scrfd.py:216-268): BGR uint8 in;
    (bboxes (N, 4) [x, y, w, h] in source pixels, kpss (N, 5, 2), scores
    (N,)) out. ``net`` runs on its parameters' device, in fp32."""

    def __init__(self, net: ScrfdNet, conf_thres: float = 0.5,
                 nms_thres: float = 0.45, input_size: int = 640):
        self.net = net.eval()
        self.conf_thres, self.nms_thres = conf_thres, nms_thres
        self.input_size = input_size

    @torch.no_grad()
    def detect(self, srcimg_bgr: np.ndarray):
        inp = self.input_size
        img, newh, neww, padh, padw = resize_image_keep_ratio(srcimg_bgr, inp, inp)
        dev = next(self.net.parameters()).device
        x = torch.from_numpy(np.ascontiguousarray(img[..., ::-1])).to(dev, torch.float32)
        outs = [tuple(t[0].float().cpu().numpy() for t in level)
                for level in self.net(x[None] / 127.5 - 1.0)]
        outs = [(s[:, 0], b, k) for s, b, k in outs]
        return decode_scrfd(outs, inp, self.net.cfg.num_anchors, self.conf_thres,
                            self.nms_thres, srcimg_bgr.shape[:2], newh, neww, padh, padw)

    def __call__(self, image_rgb: np.ndarray):
        return best_box(self.detect, image_rgb)
