"""OpenPose-format skeleton rendering, pose-sequence rescaling and the
DWPose wholebody estimator, the port's own copy of
``actalker_tpu/frontend/pose_draw.py`` (host side, numpy).

The reference's DWPose visualization (``src/dwpose/util.py``:
``draw_bodypose`` 14-55, ``draw_handpose`` 57-83, ``draw_facepose``
86-97, ``draw_pose`` 113-144) rasterizes with OpenCV; this module, as the
JAX package's, rasterizes the same geometry (confidence-scaled limb
ellipses over the 18-colour OpenPose palette, the 0.6 dim, keypoint discs,
HSV hand edges, white face dots) in vectorized numpy, so the canvases are
the JAX package's byte for byte. ``rescale_pose_sequence`` is the
reference's ``get_video_pose`` fit (``src/dwpose/preprocess.py:44-61``).

``Wholebody`` is ``src/dwpose/wholebody.py:8-63`` over the port's
``YoloXPersonDetector`` and ``RTMPoseWholebody``: person boxes, a top-down
pose per box, the neck synthesized from the shoulders and the mmpose
indices remapped to OpenPose's.
"""
from __future__ import annotations

import colorsys
import math
from typing import Dict, List

import numpy as np

_EPS = 0.01

# OpenPose 18-keypoint limb sequence and palette (reference util.py:19-25)
LIMB_SEQ = [[2, 3], [2, 6], [3, 4], [4, 5], [6, 7], [7, 8], [2, 9], [9, 10],
            [10, 11], [2, 12], [12, 13], [13, 14], [2, 1], [1, 15], [15, 17],
            [1, 16], [16, 18], [3, 17], [6, 18]]
COLORS = [[255, 0, 0], [255, 85, 0], [255, 170, 0], [255, 255, 0],
          [170, 255, 0], [85, 255, 0], [0, 255, 0], [0, 255, 85],
          [0, 255, 170], [0, 255, 255], [0, 170, 255], [0, 85, 255],
          [0, 0, 255], [85, 0, 255], [170, 0, 255], [255, 0, 255],
          [255, 0, 170], [255, 0, 85]]
HAND_EDGES = [[0, 1], [1, 2], [2, 3], [3, 4], [0, 5], [5, 6], [6, 7], [7, 8],
              [0, 9], [9, 10], [10, 11], [11, 12], [0, 13], [13, 14],
              [14, 15], [15, 16], [0, 17], [17, 18], [18, 19], [19, 20]]


def _fill_disc(canvas: np.ndarray, cx: float, cy: float, r: float, color):
    h, w, _ = canvas.shape
    x0, x1 = max(0, int(cx - r)), min(w, int(cx + r) + 2)
    y0, y1 = max(0, int(cy - r)), min(h, int(cy + r) + 2)
    if x0 >= x1 or y0 >= y1:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1]
    m = (xx - cx) ** 2 + (yy - cy) ** 2 <= r * r
    canvas[y0:y1, x0:x1][m] = color


def _fill_ellipse(canvas: np.ndarray, cx: float, cy: float, a: float,
                  b: float, angle_rad: float, color):
    """Filled rotated ellipse: semi-axes (a, b), rotation about (cx, cy)."""
    h, w, _ = canvas.shape
    r = max(a, b)
    x0, x1 = max(0, int(cx - r)), min(w, int(cx + r) + 2)
    y0, y1 = max(0, int(cy - r)), min(h, int(cy + r) + 2)
    if x0 >= x1 or y0 >= y1 or a < 0.5 or b < 0.5:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1]
    dx, dy = xx - cx, yy - cy
    c, s = math.cos(angle_rad), math.sin(angle_rad)
    u = dx * c + dy * s
    v = -dx * s + dy * c
    m = (u / a) ** 2 + (v / b) ** 2 <= 1.0
    canvas[y0:y1, x0:x1][m] = color


def _draw_segment(canvas: np.ndarray, x1, y1, x2, y2, color, thickness: int):
    """Thick line = capsule (distance-to-segment) rasterization."""
    h, w, _ = canvas.shape
    r = thickness / 2.0
    x0, xe = sorted((x1, x2))
    y0, ye = sorted((y1, y2))
    x0, xe = max(0, int(x0 - r)), min(w, int(xe + r) + 2)
    y0, ye = max(0, int(y0 - r)), min(h, int(ye + r) + 2)
    if x0 >= xe or y0 >= ye:
        return
    yy, xx = np.mgrid[y0:ye, x0:xe]
    vx, vy = x2 - x1, y2 - y1
    ll = vx * vx + vy * vy
    t = ((xx - x1) * vx + (yy - y1) * vy) / ll if ll > 0 else 0.0
    t = np.clip(t, 0.0, 1.0)
    d2 = (xx - (x1 + t * vx)) ** 2 + (yy - (y1 + t * vy)) ** 2
    canvas[y0:ye, x0:xe][d2 <= r * r] = color


def draw_bodypose(canvas: np.ndarray, candidate: np.ndarray,
                  subset: np.ndarray, score: np.ndarray,
                  size: int = 4, stickwidth: int = 4) -> np.ndarray:
    """18-keypoint body skeleton; candidate (K, 2) normalized xy."""
    h, w, _ = canvas.shape
    candidate = np.asarray(candidate, np.float64)
    subset = np.asarray(subset)
    for i in range(17):
        for n in range(len(subset)):
            idx = subset[n][np.array(LIMB_SEQ[i]) - 1]
            conf = score[n][np.array(LIMB_SEQ[i]) - 1]
            if conf[0] < 0.3 or conf[1] < 0.3 or (idx < 0).any():
                continue
            yk = candidate[idx.astype(int), 0] * w
            xk = candidate[idx.astype(int), 1] * h
            mx, my = xk.mean(), yk.mean()
            length = math.hypot(xk[0] - xk[1], yk[0] - yk[1])
            ang = math.atan2(xk[0] - xk[1], yk[0] - yk[1])
            col = [int(c * conf[0] * conf[1]) for c in COLORS[i]]
            _fill_ellipse(canvas, my, mx, max(length / 2, 1), stickwidth,
                          ang, col)
    canvas = (canvas * 0.6).astype(np.uint8)
    for i in range(18):
        for n in range(len(subset)):
            idx = int(subset[n][i])
            if idx == -1:
                continue
            x, y = candidate[idx][:2]
            col = [int(c * score[n][i]) for c in COLORS[i]]
            _fill_disc(canvas, x * w, y * h, size, col)
    return canvas


def draw_handpose(canvas: np.ndarray, all_peaks, all_scores,
                  size: int = 4, thickness: int = 2) -> np.ndarray:
    h, w, _ = canvas.shape
    for peaks, scores in zip(all_peaks, all_scores):
        for ie, (e0, e1) in enumerate(HAND_EDGES):
            x1, y1 = peaks[e0]
            x2, y2 = peaks[e1]
            if min(x1, y1, x2, y2) <= _EPS:
                continue
            sc = float(scores[e0] * scores[e1])
            rgb = colorsys.hsv_to_rgb(ie / len(HAND_EDGES), 1.0, 1.0)
            col = [int(c * 255 * sc) for c in rgb]
            _draw_segment(canvas, x1 * w, y1 * h, x2 * w, y2 * h, col,
                          thickness)
        for (x, y), sc in zip(peaks, scores):
            if x > _EPS and y > _EPS:
                _fill_disc(canvas, x * w, y * h, size,
                           [0, 0, int(sc * 255)])
    return canvas


def draw_facepose(canvas: np.ndarray, all_lmks, all_scores,
                  size: int = 3) -> np.ndarray:
    h, w, _ = canvas.shape
    for lmks, scores in zip(all_lmks, all_scores):
        for (x, y), sc in zip(lmks, scores):
            if x > _EPS and y > _EPS:
                c = int(sc * 255)
                _fill_disc(canvas, x * w, y * h, size, [c, c, c])
    return canvas


def draw_pose(pose: Dict, height: int, width: int,
              ref_w: int = 2160, include_face: bool = True) -> np.ndarray:
    """Render a full pose dict to (3, H, W) uint8 RGB (reference layout).

    ``pose``: {"bodies": {"candidate", "subset", "score"}, "hands",
    "hands_score", "faces", "faces_score"} with normalized coordinates.
    The reference rasterizes at ``ref_w`` supersampling then resizes; we
    rasterize at the target size directly (anti-aliasing differences only).
    """
    bodies = pose["bodies"]
    canvas = np.zeros((height, width, 3), np.uint8)
    canvas = draw_bodypose(canvas, bodies["candidate"], bodies["subset"],
                           bodies["score"], size=4, stickwidth=4)
    canvas = draw_handpose(canvas, pose.get("hands", []),
                           pose.get("hands_score", []))
    if include_face:
        canvas = draw_facepose(canvas, pose.get("faces", []),
                               pose.get("faces_score", []))
    return canvas.transpose(2, 0, 1)


def rescale_pose_sequence(detected: List[Dict], ref_body: np.ndarray,
                          frame_hw, ref_hw) -> List[Dict]:
    """Linear-rescale a detected pose sequence onto a reference body.

    Least-squares fit of y-coordinates against the reference keypoints and a
    matched x-scale corrected for aspect, then a shared shift — the
    reference's ``get_video_pose`` fit (``preprocess.py:44-61``).
    """
    fh, fw = frame_hw
    rh, rw = ref_hw
    bodies = np.stack([p["bodies"]["candidate"][: len(ref_body)]
                       for p in detected])
    ay, by = np.polyfit(bodies[:, :, 1].flatten(),
                        np.tile(ref_body[:, 1], len(bodies)), 1)
    ax = ay / (fh / fw / rh * rw)
    bx = float(np.mean(np.tile(ref_body[:, 0], len(bodies))
                       - bodies[:, :, 0].flatten() * ax))
    a = np.array([ax, ay])
    b = np.array([bx, by])
    out = []
    for p in detected:
        q = {**p, "bodies": dict(p["bodies"])}
        q["bodies"]["candidate"] = p["bodies"]["candidate"] * a + b
        if "faces" in p:
            q["faces"] = np.asarray(p["faces"]) * a + b
        if "hands" in p:
            q["hands"] = np.asarray(p["hands"]) * a + b
        out.append(q)
    return out


class Wholebody:
    """The DWPose two-stage wholebody estimator: ``det`` (a
    ``models.yolox.YoloXPersonDetector``: BGR image -> (N, 4) xyxy person
    boxes) then ``pose`` (a ``models.rtmpose.RTMPoseWholebody``: image and
    boxes -> keypoints (N, 133, 2), scores (N, 133)). Returns (keypoints
    (N, 134, 2), scores (N, 134)) in source pixels, OpenPose's body order
    in the first 18."""

    def __init__(self, det, pose):
        self.det, self.pose = det, pose

    def __call__(self, image_bgr: np.ndarray):
        boxes = self.det(image_bgr)
        keypoints, scores = self.pose(image_bgr, boxes)
        info = np.concatenate([keypoints, scores[..., None]], axis=-1)
        # synthesize the neck joint from the shoulders (wholebody.py:40-45)
        neck = info[:, [5, 6]].mean(axis=1)
        neck[:, 2:] = np.logical_and(info[:, 5, 2:] > 0.3,
                                     info[:, 6, 2:] > 0.3).astype(np.float64)
        info = np.insert(info, 17, neck, axis=1)
        mmpose_idx = [17, 6, 8, 10, 7, 9, 12, 14, 16, 13, 15, 2, 1, 4, 3]
        openpose_idx = [1, 2, 3, 4, 6, 7, 8, 9, 10, 12, 13, 14, 15, 16, 17]
        info[:, openpose_idx] = info[:, mmpose_idx]
        return info[..., :2], info[..., 2]
