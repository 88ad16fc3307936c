"""S3FD face detector of the sync evaluation, twin of
``actalker_tpu/evaluation/s3fd.py`` and keyed as the reference's
``eval/detectors/s3fd/nets.py`` (``sfd_face.pth``: ``vgg.K`` at the
ModuleList's indices, ``L2Norm3_3`` / ``4_3`` / ``5_3.weight``,
``extras.K``, ``loc.K``, ``conf.K``).

The conv backbone and multibox heads run on the device; the prior, decode
and NMS tail is host numpy as ``eval/detectors/s3fd/box_utils.py`` (greedy
NMS, centre-offset decode with variances (0.1, 0.2), the max-out
background of ``nets.py:144-145``). ``S3FD.detect_faces`` follows
``eval/detectors/s3fd/__init__.py:27-61``; a scale other than 1 resizes
with cv2's bilinear (``cv2.resize(..., INTER_LINEAR)``, no antialiasing)
as the reference does, where the JAX twin's ``jax.image.resize``
antialiases (ROADMAP queue 3).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from actalker_tpu_torch.models.scrfd import cv_bilinear_resize

# VGG16 conv layout: ModuleList index -> (in, out, kernel, padding, dilation)
_VGG = {0: (3, 64, 3, 1, 1), 2: (64, 64, 3, 1, 1), 5: (64, 128, 3, 1, 1),
        7: (128, 128, 3, 1, 1), 10: (128, 256, 3, 1, 1), 12: (256, 256, 3, 1, 1),
        14: (256, 256, 3, 1, 1), 17: (256, 512, 3, 1, 1), 19: (512, 512, 3, 1, 1),
        21: (512, 512, 3, 1, 1), 24: (512, 512, 3, 1, 1), 26: (512, 512, 3, 1, 1),
        28: (512, 512, 3, 1, 1), 31: (512, 1024, 3, 6, 6), 33: (1024, 1024, 1, 0, 1)}
_POOLS = {4: False, 9: False, 16: True, 23: False, 30: False}   # index -> ceil_mode
_SOURCE_CH = (256, 512, 512, 1024, 512, 256)
_MIN_SIZES = (16, 32, 64, 128, 256, 512)
_STEPS = (4, 8, 16, 32, 64, 128)
_VARIANCE = (0.1, 0.2)
# BGR pixel means (eval/detectors/s3fd/__init__.py:10)
_IMG_MEAN = np.array([104.0, 117.0, 123.0], np.float32)


class L2Norm(nn.Module):
    def __init__(self, channels: int, scale: float):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), float(scale)))

    def forward(self, x):
        return self.weight[None, :, None, None] * x / (
            x.square().sum(1, keepdim=True).sqrt() + 1e-10)


class S3FDNet(nn.Module):
    """(B, 3, H, W) BGR minus the channel means -> ([(B, h, w, 4) loc per
    scale], [(B, h, w, 2) softmax face probabilities per scale])."""

    def __init__(self):
        super().__init__()
        layers = []
        for i in range(35):
            if i in _VGG:
                ci, co, k, p, d = _VGG[i]
                layers.append(nn.Conv2d(ci, co, k, 1, padding=p, dilation=d))
            elif i in _POOLS:
                layers.append(nn.MaxPool2d(2, 2, ceil_mode=_POOLS[i]))
            else:
                layers.append(nn.ReLU())
        self.vgg = nn.ModuleList(layers)
        self.L2Norm3_3 = L2Norm(256, 10)
        self.L2Norm4_3 = L2Norm(512, 8)
        self.L2Norm5_3 = L2Norm(512, 5)
        self.extras = nn.ModuleList([
            nn.Conv2d(1024, 256, 1, 1), nn.Conv2d(256, 512, 3, 2, padding=1),
            nn.Conv2d(512, 128, 1, 1), nn.Conv2d(128, 256, 3, 2, padding=1)])
        self.loc = nn.ModuleList([nn.Conv2d(c, 4, 3, 1, padding=1) for c in _SOURCE_CH])
        self.conf = nn.ModuleList([nn.Conv2d(c, 4 if i == 0 else 2, 3, 1, padding=1)
                                   for i, c in enumerate(_SOURCE_CH)])

    def forward(self, x) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        sources = []
        for lo, hi, norm in ((0, 16, self.L2Norm3_3), (16, 23, self.L2Norm4_3),
                             (23, 30, self.L2Norm5_3), (30, 35, None)):
            for k in range(lo, hi):
                x = self.vgg[k](x)
            sources.append(norm(x) if norm is not None else x)
        for k, v in enumerate(self.extras):
            x = F.relu(v(x))
            if k % 2 == 1:
                sources.append(x)
        locs, confs = [], []
        for i, s in enumerate(sources):
            conf = self.conf[i](s)
            if i == 0:      # max-out background label (nets.py:144-145)
                conf = torch.cat([conf[:, 0:3].amax(1, keepdim=True), conf[:, 3:]], 1)
            locs.append(self.loc[i](s).permute(0, 2, 3, 1))
            confs.append(F.softmax(conf, dim=1).permute(0, 2, 3, 1))
        return locs, confs


def priors_for(size_hw: Tuple[int, int],
               fmaps: Sequence[Tuple[int, int]]) -> np.ndarray:
    """PriorBox (box_utils.py:176-217): (N, 4) [cx, cy, w, h] normalized."""
    imh, imw = size_hw
    out = []
    for k, (fh, fw) in enumerate(fmaps):
        step, ms = _STEPS[k], _MIN_SIZES[k]
        j, i = np.meshgrid(np.arange(fw), np.arange(fh))
        cx = (j + 0.5) * step / imw
        cy = (i + 0.5) * step / imh
        boxes = np.stack([cx, cy, np.full_like(cx, ms / imw),
                          np.full_like(cy, ms / imh)], -1)
        out.append(boxes.reshape(-1, 4))
    return np.concatenate(out, 0).astype(np.float32)


def decode_boxes(loc: np.ndarray, priors: np.ndarray) -> np.ndarray:
    """Centre-offset decode (box_utils.py:41-59) -> (N, 4) xyxy normalized."""
    v0, v1 = _VARIANCE
    cxy = priors[:, :2] + loc[:, :2] * v0 * priors[:, 2:]
    wh = priors[:, 2:] * np.exp(loc[:, 2:] * v1)
    return np.concatenate([cxy - wh / 2, cxy + wh / 2], 1)


def nms(dets: np.ndarray, thresh: float) -> np.ndarray:
    """Greedy IoU NMS over (N, 5) [x1 y1 x2 y2 score] (box_utils.py:7-38)."""
    if len(dets) == 0:
        return np.zeros((0,), np.int32)
    x1, y1, x2, y2, scores = dets.T
    areas = (x2 - x1) * (y2 - y1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = np.maximum(0.0, xx2 - xx1) * np.maximum(0.0, yy2 - yy1)
        iou = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[1:][iou <= thresh]
    return np.asarray(keep, np.int32)


class S3FD:
    """``detect_faces`` with the reference's semantics: a BGR uint8 image
    in, (N, 5) [x1 y1 x2 y2 score] out; a ``conf_th`` filter and a
    cross-scale NMS(0.1). ``net`` is an ``S3FDNet`` on its device."""

    def __init__(self, net: S3FDNet):
        self.net = net
        self.device = next(net.parameters()).device

    @torch.no_grad()
    def detect_faces(self, image_bgr: np.ndarray, conf_th: float = 0.8,
                     scales: Sequence[float] = (1.0,), conf_thresh: float = 0.05,
                     nms_thresh: float = 0.3) -> np.ndarray:
        h, w = image_bgr.shape[:2]
        all_dets = []
        for s in scales:
            img = image_bgr if s == 1.0 else cv_bilinear_resize(
                image_bgr, int(round(h * s)), int(round(w * s)))
            x = torch.from_numpy(img.astype(np.float32) - _IMG_MEAN).to(self.device)
            locs, confs = self.net(x.permute(2, 0, 1)[None])
            fmaps = [tuple(l.shape[1:3]) for l in locs]
            priors = priors_for(img.shape[:2], fmaps)
            loc = torch.cat([l.reshape(-1, 4) for l in locs]).cpu().numpy()
            prob = torch.cat([c[..., 1].reshape(-1) for c in confs]).cpu().numpy()
            boxes = decode_boxes(loc, priors)
            m = prob > conf_thresh
            if not m.any():
                continue
            dets = np.concatenate([boxes[m] * [w, h, w, h], prob[m, None]], 1)
            dets = dets[nms(dets, nms_thresh)[:750]]
            all_dets.append(dets[dets[:, 4] > conf_th])
        if not all_dets:
            return np.zeros((0, 5), np.float32)
        dets = np.concatenate(all_dets, 0)
        return dets[nms(dets, 0.1)]       # cross-scale merge (s3fd/__init__.py:58)
