"""YOLOv5-face detector (boxes with 5 landmarks), twin of
``actalker_tpu/models/yoloface.py`` (the reference loads the public
deepcam-cn/yolov5-face graph as TorchScript; its detect wrapper is
``src/utils/face_align/yoloface.py:213-293``): a CSP backbone with a
StemBlock, a PAN neck and a Detect head that regresses 5 facial landmarks
beside each box (rows ``[cx, cy, w, h, obj, 10 x landmark, cls]``).

Keyed as a yolov5-face state dict: ``model.N.*`` (N = 0..22; 10 / 11 / 14
/ 15 / 18 / 21 are the parameter-free upsample / concat layers), each conv
a ``conv`` + ``bn`` (eps 1e-3) pair, the Detect convs ``model.23.m.{0,1,2}``.
Detect's ``anchors`` / ``anchor_grid`` entries, where a file has them,
are the published anchors (``ANCHORS``) and are ignored on load.

``YoloFaceDetector`` is the host wrapper: a letterbox resize to multiples
of 32 (bilinear with antialiasing, as ``jax.image.resize``), the network on
its device, the confidence filter and greedy NMS on the host.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from actalker_tpu_torch.models.common import FrozenBatchNorm

# wh pairs per level, strides 8 / 16 / 32
ANCHORS = (((4, 5), (8, 10), (13, 16)),
           ((23, 29), (43, 55), (73, 105)),
           ((146, 217), (231, 300), (335, 433)))
STRIDES = (8, 16, 32)


@dataclass
class YoloFaceConfig:
    """Width / depth multiples select the variant (s: 0.50 / 0.33, m: 0.75
    / 0.67, l: 1.0 / 1.0; the reference ships m)."""
    width_multiple: float = 0.75
    depth_multiple: float = 0.67
    num_classes: int = 1

    def ch(self, c: int) -> int:
        return int(math.ceil(c * self.width_multiple / 8) * 8)

    def depth(self, n: int) -> int:
        return max(round(n * self.depth_multiple), 1)


class Conv(nn.Module):
    """conv (no bias) -> BatchNorm (eps 1e-3) -> SiLU."""

    def __init__(self, cin, cout, k=1, s=1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, s, k // 2, bias=False)
        self.bn = FrozenBatchNorm(cout, eps=1e-3)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    def __init__(self, cin, cout, shortcut=True):
        super().__init__()
        self.cv1, self.cv2 = Conv(cin, cout, 1), Conv(cout, cout, 3)
        self.add = shortcut and cin == cout

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3(nn.Module):
    def __init__(self, cin, cout, n=1, shortcut=True):
        super().__init__()
        c_ = cout // 2
        self.cv1, self.cv2 = Conv(cin, c_, 1), Conv(cin, c_, 1)
        self.cv3 = Conv(2 * c_, cout, 1)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut) for _ in range(n)))

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class SPP(nn.Module):
    def __init__(self, cin, cout, ks=(3, 5, 7)):
        super().__init__()
        self.cv1 = Conv(cin, cin // 2, 1)
        self.cv2 = Conv(cin // 2 * (len(ks) + 1), cout, 1)
        self.ks = ks

    def forward(self, x):
        x = self.cv1(x)
        return self.cv2(torch.cat([x] + [F.max_pool2d(x, k, 1, k // 2)
                                         for k in self.ks], 1))


class StemBlock(nn.Module):
    """stem_1 (3x3 / 2) -> [stem_2a / 2b (1x1, 3x3 / 2) || a 2x2 ceil
    max-pool] -> concat -> stem_3 (1x1); stride 4."""

    def __init__(self, cin, cout):
        super().__init__()
        self.stem_1 = Conv(cin, cout, 3, 2)
        self.stem_2a = Conv(cout, cout // 2, 1)
        self.stem_2b = Conv(cout // 2, cout, 3, 2)
        self.stem_3 = Conv(2 * cout, cout, 1)

    def forward(self, x):
        x = self.stem_1(x)
        p = F.max_pool2d(x, 2, 2, ceil_mode=True)
        return self.stem_3(torch.cat([self.stem_2b(self.stem_2a(x)), p], 1))


class Detect(nn.Module):
    def __init__(self, chs, no):
        super().__init__()
        self.m = nn.ModuleList(nn.Conv2d(c, 3 * no, 1) for c in chs)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        for name in ("anchors", "anchor_grid"):
            state_dict.pop(prefix + name, None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class YoloFaceNet(nn.Module):
    """(B, H, W, 3) RGB in [0, 1], H and W multiples of 32 -> decoded
    predictions (B, N, 15 + nc) in input pixels."""

    def __init__(self, cfg: YoloFaceConfig = None):
        super().__init__()
        self.cfg = cfg = cfg or YoloFaceConfig()
        ch, d = cfg.ch, cfg.depth
        self.no = 15 + cfg.num_classes
        self.model = nn.ModuleList([
            StemBlock(3, ch(64)), C3(ch(64), ch(128), d(3)),
            Conv(ch(128), ch(256), 3, 2), C3(ch(256), ch(256), d(9)),
            Conv(ch(256), ch(512), 3, 2), C3(ch(512), ch(512), d(9)),
            Conv(ch(512), ch(1024), 3, 2), SPP(ch(1024), ch(1024)),
            C3(ch(1024), ch(1024), d(3), False),
            Conv(ch(1024), ch(512), 1),                        # 9
            nn.Upsample(scale_factor=2), nn.Identity(),        # 10, 11 concat
            C3(ch(1024), ch(512), d(3), False),                # 12
            Conv(ch(512), ch(256), 1),                         # 13
            nn.Upsample(scale_factor=2), nn.Identity(),        # 14, 15 concat
            C3(ch(512), ch(256), d(3), False),                 # 16
            Conv(ch(256), ch(256), 3, 2), nn.Identity(),       # 17, 18 concat
            C3(ch(512), ch(512), d(3), False),                 # 19
            Conv(ch(512), ch(512), 3, 2), nn.Identity(),       # 20, 21 concat
            C3(ch(1024), ch(1024), d(3), False),               # 22
            Detect((ch(256), ch(512), ch(1024)), self.no)])    # 23

    def forward(self, x):
        L = self.model
        x = L[2](L[1](L[0](x.permute(0, 3, 1, 2))))
        p3 = L[3](x)
        p4 = L[5](L[4](p3))
        t5 = L[9](L[8](L[7](L[6](p4))))
        t4 = L[13](L[12](torch.cat([L[10](t5), p4], 1)))
        o3 = L[16](torch.cat([L[14](t4), p3], 1))
        o4 = L[19](torch.cat([L[17](o3), t4], 1))
        o5 = L[22](torch.cat([L[20](o4), t5], 1))
        preds = []
        for li, (feat, conv) in enumerate(zip((o3, o4, o5), L[23].m)):
            raw = conv(feat)
            b, _, ny, nx = raw.shape
            raw = raw.reshape(b, 3, self.no, ny, nx).permute(0, 3, 4, 1, 2)
            stride = float(STRIDES[li])
            anchors = torch.tensor(ANCHORS[li], dtype=raw.dtype, device=raw.device)
            gy, gx = torch.meshgrid(torch.arange(ny, device=raw.device, dtype=raw.dtype),
                                    torch.arange(nx, device=raw.device, dtype=raw.dtype),
                                    indexing="ij")
            grid = torch.stack([gx, gy], -1)[:, :, None, :]          # (ny, nx, 1, 2)
            xy = (torch.sigmoid(raw[..., 0:2]) * 2.0 - 0.5 + grid) * stride
            wh = (torch.sigmoid(raw[..., 2:4]) * 2.0) ** 2 * anchors
            obj = torch.sigmoid(raw[..., 4:5])
            lmk = (raw[..., 5:15].reshape(b, ny, nx, 3, 5, 2) * anchors[:, None, :]
                   + (grid * stride)[..., None, :]).reshape(b, ny, nx, 3, 10)
            cls = torch.sigmoid(raw[..., 15:])
            preds.append(torch.cat([xy, wh, obj, lmk, cls], -1)
                         .reshape(b, ny * nx * 3, self.no))
        return torch.cat(preds, 1)


def nms_xyxy(boxes: np.ndarray, scores: np.ndarray, iou_thres: float) -> np.ndarray:
    """Greedy IoU NMS (torchvision.ops.nms semantics, the reference's
    yoloface.py:195): indices kept, best score first."""
    order = scores.argsort()[::-1]
    x1, y1, x2, y2 = boxes.T
    areas = (x2 - x1) * (y2 - y1)
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = np.maximum(0, xx2 - xx1) * np.maximum(0, yy2 - yy1)
        iou = inter / (areas[i] + areas[order[1:]] - inter + 1e-12)
        order = order[1:][iou <= iou_thres]
    return np.asarray(keep, np.int32)


def _empty():
    return np.zeros((0, 4)), np.zeros((0, 5, 2)), np.zeros((0,))


def decode_yoloface(pred: np.ndarray, conf_thres: float, iou_thres: float,
                    scale_xy: Tuple[float, float]):
    """One image's (N, 15 + nc) predictions -> (bboxes (K, 4) [x, y, w, h],
    kpss (K, 5, 2), scores (K,)), scaled by ``scale_xy`` back to the source
    pixels (the reference's yoloface.py:227-293)."""
    cand = pred[pred[:, 4] > conf_thres]
    if len(cand):
        conf = cand[:, 4] * cand[:, 15:].max(axis=1)
        cand, conf = cand[conf > conf_thres], conf[conf > conf_thres]
    if len(cand) == 0:
        return _empty()
    boxes = np.stack([cand[:, 0] - cand[:, 2] / 2, cand[:, 1] - cand[:, 3] / 2,
                      cand[:, 0] + cand[:, 2] / 2, cand[:, 1] + cand[:, 3] / 2], 1)
    keep = nms_xyxy(boxes, conf, iou_thres)
    boxes, cand, conf = boxes[keep], cand[keep], conf[keep]
    sx, sy = scale_xy
    bboxes = np.stack([boxes[:, 0] * sx, boxes[:, 1] * sy,
                       (boxes[:, 2] - boxes[:, 0]) * sx,
                       (boxes[:, 3] - boxes[:, 1]) * sy], 1)
    return bboxes, cand[:, 5:15].reshape(-1, 5, 2) * np.array([[sx, sy]]), conf


def best_box(detect, image_rgb: np.ndarray):
    """The ``frontend.face.FaceDetector`` protocol over a ``detect(bgr)``:
    the highest-scoring box as (x1, y1, x2, y2), or None."""
    bboxes, _, scores = detect(np.ascontiguousarray(image_rgb[..., ::-1]))
    if len(bboxes) == 0:
        return None
    x, y, w, h = bboxes[np.argmax(scores)]
    return (float(x), float(y), float(x + w), float(y + h))


class YoloFaceDetector:
    """The reference's detect semantics (``yoloface.py:226-293``): BGR uint8
    in; (bboxes (N, 4) as [x, y, w, h] in source pixels, kpss (N, 5, 2),
    scores (N,)) out. ``net`` runs on its parameters' device, in fp32."""

    def __init__(self, net: YoloFaceNet, conf_thres: float = 0.5,
                 iou_thres: float = 0.45, input_size: int = 416):
        self.net = net.eval()
        self.conf_thres, self.iou_thres = conf_thres, iou_thres
        self.input_size = input_size

    def letterbox(self, image_bgr: np.ndarray) -> torch.Tensor:
        """The RGB image resized so its short side is ``input_size``, both
        sides rounded up to multiples of 32, in [0, 1]: (1, H1, W1, 3)."""
        h0, w0 = image_bgr.shape[:2]
        r = self.input_size / min(h0, w0)
        h1 = (int(h0 * r) + 31) // 32 * 32
        w1 = (int(w0 * r) + 31) // 32 * 32
        dev = next(self.net.parameters()).device
        x = torch.from_numpy(np.ascontiguousarray(image_bgr[..., ::-1])).to(
            dev, torch.float32).permute(2, 0, 1)[None]
        x = F.interpolate(x, size=(h1, w1), mode="bilinear", align_corners=False,
                          antialias=True)
        return x.permute(0, 2, 3, 1) / 255.0

    @torch.no_grad()
    def detect(self, image_bgr: np.ndarray):
        h0, w0 = image_bgr.shape[:2]
        x = self.letterbox(image_bgr)
        pred = self.net(x)[0].float().cpu().numpy()
        h1, w1 = x.shape[1:3]
        return decode_yoloface(pred, self.conf_thres, self.iou_thres,
                               (w0 / w1, h0 / h1))

    def __call__(self, image_rgb: np.ndarray):
        return best_box(self.detect, image_rgb)
