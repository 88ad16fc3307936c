"""YOLOX person detector (DWPose stage 1), twin of
``actalker_tpu/models/yolox.py`` (the reference's DWPose runs YOLOX-L as
ONNX, ``src/dwpose/wholebody.py:20-26``, ``src/dwpose/onnxdet.py:76-145``).

The network is the public Megvii graph: a CSPDarknet (Focus stem, four
stride-2 stages of a conv and a CSP layer, an SPP bottleneck in the last),
a PAFPN and the decoupled head. Its modules carry the Megvii state dict's
names (``backbone.backbone.stem.conv.conv.weight``, ``backbone.C3_p4.*``,
``head.stems.{i}``, ``head.cls_preds.{i}``, ...), each conv a ``conv`` +
``bn`` pair, the BatchNorm a real eval-mode one with Megvii's eps 1e-3,
so ``yolox_l.pth`` loads with ``strict=True``. It returns the raw rows
``[dx, dy, log w, log h, obj, cls...]`` (obj / cls sigmoided) before the
grid decode, as the ONNX export does.

Host tail (numpy), as ``onnxdet.py``: a pad-to-114 letterbox (bilinear
with antialiasing, as ``jax.image.resize``; ``onnxdet.py`` uses
``cv2.resize(INTER_LINEAR)``, which differs when it shrinks), the grid /
stride decode, the legacy +1 greedy NMS per class, and the person-class
and score filter. ``YoloXPersonDetector`` runs the network on its
parameters' device, in fp32.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

STRIDES = (8, 16, 32)


@dataclass
class YoloXConfig:
    """l: 1.0 / 1.0 (the DWPose detector), m: 0.67 / 0.75, s: 0.33 / 0.50."""
    depth: float = 1.0
    width: float = 1.0
    num_classes: int = 80

    def ch(self, c: int) -> int:
        return int(c * self.width)

    def n(self, d: int) -> int:
        return max(round(d * self.depth), 1)


class BaseConv(nn.Module):
    """conv (no bias) -> BatchNorm (eps 1e-3) -> SiLU."""

    def __init__(self, cin, cout, k=1, s=1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, s, k // 2, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    def __init__(self, cin, cout, shortcut=True):
        super().__init__()
        self.conv1, self.conv2 = BaseConv(cin, cout, 1), BaseConv(cout, cout, 3)
        self.add = shortcut and cin == cout

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return x + y if self.add else y


class CSPLayer(nn.Module):
    def __init__(self, cin, cout, n=1, shortcut=True):
        super().__init__()
        c_ = cout // 2
        self.conv1, self.conv2 = BaseConv(cin, c_, 1), BaseConv(cin, c_, 1)
        self.conv3 = BaseConv(2 * c_, cout, 1)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut) for _ in range(n)))

    def forward(self, x):
        return self.conv3(torch.cat([self.m(self.conv1(x)), self.conv2(x)], 1))


class SPPBottleneck(nn.Module):
    def __init__(self, cin, cout, ks=(5, 9, 13)):
        super().__init__()
        self.conv1 = BaseConv(cin, cin // 2, 1)
        self.conv2 = BaseConv(cin // 2 * (len(ks) + 1), cout, 1)
        self.ks = ks

    def forward(self, x):
        x = self.conv1(x)
        return self.conv2(torch.cat([x] + [F.max_pool2d(x, k, 1, k // 2)
                                           for k in self.ks], 1))


class Focus(nn.Module):
    """Space-to-depth 2x (top-left, bottom-left, top-right, bottom-right),
    then a conv."""

    def __init__(self, cin, cout, k=3):
        super().__init__()
        self.conv = BaseConv(4 * cin, cout, k)

    def forward(self, x):
        return self.conv(torch.cat([x[..., ::2, ::2], x[..., 1::2, ::2],
                                    x[..., ::2, 1::2], x[..., 1::2, 1::2]], 1))


class CSPDarknet(nn.Module):
    def __init__(self, cfg: YoloXConfig):
        super().__init__()
        ch, n = cfg.ch, cfg.n
        self.stem = Focus(3, ch(64), 3)
        self.dark2 = nn.Sequential(BaseConv(ch(64), ch(128), 3, 2),
                                   CSPLayer(ch(128), ch(128), n(3)))
        self.dark3 = nn.Sequential(BaseConv(ch(128), ch(256), 3, 2),
                                   CSPLayer(ch(256), ch(256), n(9)))
        self.dark4 = nn.Sequential(BaseConv(ch(256), ch(512), 3, 2),
                                   CSPLayer(ch(512), ch(512), n(9)))
        self.dark5 = nn.Sequential(BaseConv(ch(512), ch(1024), 3, 2),
                                   SPPBottleneck(ch(1024), ch(1024)),
                                   CSPLayer(ch(1024), ch(1024), n(3), shortcut=False))

    def forward(self, x):
        d3 = self.dark3(self.dark2(self.stem(x)))
        d4 = self.dark4(d3)
        return d3, d4, self.dark5(d4)


class YOLOPAFPN(nn.Module):
    def __init__(self, cfg: YoloXConfig):
        super().__init__()
        ch, n = cfg.ch, cfg.n
        self.backbone = CSPDarknet(cfg)
        self.lateral_conv0 = BaseConv(ch(1024), ch(512), 1)
        self.C3_p4 = CSPLayer(ch(1024), ch(512), n(3), False)
        self.reduce_conv1 = BaseConv(ch(512), ch(256), 1)
        self.C3_p3 = CSPLayer(ch(512), ch(256), n(3), False)
        self.bu_conv2 = BaseConv(ch(256), ch(256), 3, 2)
        self.C3_n3 = CSPLayer(ch(512), ch(512), n(3), False)
        self.bu_conv1 = BaseConv(ch(512), ch(512), 3, 2)
        self.C3_n4 = CSPLayer(ch(1024), ch(1024), n(3), False)

    def forward(self, x):
        d3, d4, d5 = self.backbone(x)
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")  # noqa: E731
        l0 = self.lateral_conv0(d5)
        r1 = self.reduce_conv1(self.C3_p4(torch.cat([up(l0), d4], 1)))
        out2 = self.C3_p3(torch.cat([up(r1), d3], 1))
        out1 = self.C3_n3(torch.cat([self.bu_conv2(out2), r1], 1))
        out0 = self.C3_n4(torch.cat([self.bu_conv1(out1), l0], 1))
        return out2, out1, out0


class YOLOXHead(nn.Module):
    def __init__(self, cfg: YoloXConfig):
        super().__init__()
        ch, c = cfg.ch, cfg.ch(256)
        self.stems = nn.ModuleList(BaseConv(ch(cin), c, 1) for cin in (256, 512, 1024))
        self.cls_convs = nn.ModuleList(nn.Sequential(BaseConv(c, c, 3), BaseConv(c, c, 3))
                                       for _ in range(3))
        self.reg_convs = nn.ModuleList(nn.Sequential(BaseConv(c, c, 3), BaseConv(c, c, 3))
                                       for _ in range(3))
        self.cls_preds = nn.ModuleList(nn.Conv2d(c, cfg.num_classes, 1) for _ in range(3))
        self.reg_preds = nn.ModuleList(nn.Conv2d(c, 4, 1) for _ in range(3))
        self.obj_preds = nn.ModuleList(nn.Conv2d(c, 1, 1) for _ in range(3))

    def forward(self, feats):
        outs = []
        for i, x in enumerate(feats):
            s = self.stems[i](x)
            cf, rf = self.cls_convs[i](s), self.reg_convs[i](s)
            y = torch.cat([self.reg_preds[i](rf), torch.sigmoid(self.obj_preds[i](rf)),
                           torch.sigmoid(self.cls_preds[i](cf))], 1)
            outs.append(y.flatten(2))
        return torch.cat(outs, 2).permute(0, 2, 1)


class YoloXNet(nn.Module):
    """(B, H, W, 3) float32 letterboxed BGR pixels in 0..255 (the ONNX
    export takes them unnormalized) -> (B, N, 5 + nc) raw rows before the
    grid decode, N over strides 8 / 16 / 32 in row-major order."""

    def __init__(self, cfg: YoloXConfig = None):
        super().__init__()
        self.cfg = cfg = cfg or YoloXConfig()
        self.backbone = YOLOPAFPN(cfg)
        self.head = YOLOXHead(cfg)

    def forward(self, x):
        return self.head(self.backbone(x.permute(0, 3, 1, 2)))


def decode_predictions(outputs: np.ndarray, img_size: Tuple[int, int]) -> np.ndarray:
    """``demo_postprocess`` (onnxdet.py:76-96): fold the anchor grid in."""
    grids, strides = [], []
    for s in STRIDES:
        hs, ws = img_size[0] // s, img_size[1] // s
        xv, yv = np.meshgrid(np.arange(ws), np.arange(hs))
        grids.append(np.stack((xv, yv), 2).reshape(1, -1, 2))
        strides.append(np.full((1, hs * ws, 1), s))
    grid = np.concatenate(grids, 1).astype(np.float32)
    stride = np.concatenate(strides, 1).astype(np.float32)
    out = outputs.copy()
    out[..., :2] = (out[..., :2] + grid) * stride
    out[..., 2:4] = np.exp(out[..., 2:4]) * stride
    return out


def nms_plus1(boxes: np.ndarray, scores: np.ndarray, thr: float) -> List[int]:
    """Greedy NMS with the legacy +1 area convention (onnxdet.py:5-41)."""
    x1, y1, x2, y2 = boxes.T
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = np.maximum(0.0, xx2 - xx1 + 1) * np.maximum(0.0, yy2 - yy1 + 1)
        ovr = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[1:][ovr <= thr]
    return keep


def multiclass_nms(boxes, scores, nms_thr, score_thr):
    """Class-aware NMS (onnxdet.py:43-74); (N, 6) rows [box, score, class],
    or None."""
    final = []
    for cls in range(scores.shape[1]):
        cs = scores[:, cls]
        m = cs > score_thr
        if not m.any():
            continue
        keep = nms_plus1(boxes[m], cs[m], nms_thr)
        if keep:
            final.append(np.concatenate(
                [boxes[m][keep], cs[m][keep, None],
                 np.full((len(keep), 1), cls, np.float32)], 1))
    return np.concatenate(final, 0) if final else None


def letterbox(img: np.ndarray, input_size: Tuple[int, int]):
    """Pad-to-114 resize (onnxdet.py:98-114): (padded (H, W, 3) float32,
    ratio). The resize is bilinear with antialiasing, in torch on the
    CPU."""
    padded = np.full((input_size[0], input_size[1], 3), 114.0, np.float32)
    r = min(input_size[0] / img.shape[0], input_size[1] / img.shape[1])
    nh, nw = int(img.shape[0] * r), int(img.shape[1] * r)
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32)).permute(2, 0, 1)[None]
    x = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False,
                      antialias=True)
    padded[:nh, :nw] = x[0].permute(1, 2, 0).numpy()
    return padded, r


class YoloXPersonDetector:
    """``inference_detector`` (onnxdet.py:116-145): a BGR image in, (N, 4)
    xyxy person boxes out (class 0, score > 0.3 after NMS 0.45 over scores
    > 0.1). ``net`` runs on its parameters' device, in fp32."""

    def __init__(self, net: YoloXNet, input_size: Tuple[int, int] = (640, 640)):
        self.net = net.eval()
        self.input_size = input_size

    @torch.no_grad()
    def __call__(self, image_bgr: np.ndarray) -> np.ndarray:
        padded, ratio = letterbox(image_bgr, self.input_size)
        dev = next(self.net.parameters()).device
        raw = self.net(torch.from_numpy(padded)[None].to(dev)).float().cpu().numpy()
        pred = decode_predictions(raw, self.input_size)[0]
        boxes = pred[:, :4]
        scores = pred[:, 4:5] * pred[:, 5:]
        xyxy = np.stack([boxes[:, 0] - boxes[:, 2] / 2, boxes[:, 1] - boxes[:, 3] / 2,
                         boxes[:, 0] + boxes[:, 2] / 2, boxes[:, 1] + boxes[:, 3] / 2],
                        1) / ratio
        dets = multiclass_nms(xyxy, scores, nms_thr=0.45, score_thr=0.1)
        if dets is None:
            return np.zeros((0, 4), np.float32)
        keep = (dets[:, 4] > 0.3) & (dets[:, 5] == 0)
        return dets[keep, :4]
