"""Vectorized Viola-Jones face detector (numpy), the port's own copy of
``actalker_tpu/frontend/viola_jones.py``.

An evaluator for OpenCV's Haar cascade XML models (OpenCV 5 dropped
``CascadeClassifier`` but still ships the XMLs): integral-image Haar
features, small decision trees, staged rejection, vectorized across all
sliding windows of a scale. It backs the frontend's default face detector.
"""
from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET
from typing import List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class _Stage:
    threshold: float
    # per weak classifier: internal nodes (n_nodes, 4: feat_idx, thresh,
    # left_idx, right_idx as leaf refs) and leaf values
    trees: List[Tuple[np.ndarray, np.ndarray]]


@dataclasses.dataclass
class CascadeModel:
    window: Tuple[int, int]          # (h, w)
    stages: List[_Stage]
    rects: np.ndarray                # (n_feats, 3, 5): up to 3 rects (x,y,w,h,weight)

    @classmethod
    def load(cls, path: str) -> "CascadeModel":
        root = ET.parse(path).getroot()
        casc = root.find("cascade")
        h = int(casc.findtext("height"))
        w = int(casc.findtext("width"))
        feats = []
        for f in casc.find("features"):
            rects = np.zeros((3, 5), np.float64)
            for i, r in enumerate(f.find("rects")):
                vals = r.text.split()
                rects[i] = [float(v) for v in vals[:5]]
            feats.append(rects)
        rects = np.stack(feats)
        stages = []
        for s in casc.find("stages"):
            st = _Stage(float(s.findtext("stageThreshold")), [])
            for wc in s.find("weakClassifiers"):
                internal = np.array(
                    [float(v) for v in wc.findtext("internalNodes").split()],
                    np.float64,
                ).reshape(-1, 4)
                # columns: left_child, right_child, feature_idx, threshold
                leaves = np.array(
                    [float(v) for v in wc.findtext("leafValues").split()],
                    np.float64,
                )
                st.trees.append((internal, leaves))
            stages.append(st)
        return cls((h, w), stages, rects)


def _integral(img: np.ndarray) -> np.ndarray:
    ii = np.zeros((img.shape[0] + 1, img.shape[1] + 1), np.float64)
    ii[1:, 1:] = img.cumsum(0).cumsum(1)
    return ii


def _rect_sums(ii, ys, xs, rects_scaled):
    """Sum of each weighted rect over windows at (ys, xs).

    rects_scaled: (3, 5) ints scaled to the window scale."""
    total = np.zeros(ys.shape, np.float64)
    for rx, ry, rw, rh, weight in rects_scaled:
        if weight == 0.0:
            continue
        x1 = xs + int(rx)
        y1 = ys + int(ry)
        x2 = x1 + int(rw)
        y2 = y1 + int(rh)
        total += weight * (ii[y2, x2] - ii[y1, x2] - ii[y2, x1] + ii[y1, x1])
    return total


class ViolaJones:
    def __init__(self, model: CascadeModel):
        self.m = model

    def detect(self, gray: np.ndarray, scale_factor: float = 1.2,
               min_size: int = 48, step_frac: float = 0.08,
               max_windows: int = 200000) -> List[Tuple[int, int, int, int]]:
        """gray: (H, W) uint8/float -> list of (x, y, w, h) detections."""
        gray = gray.astype(np.float64)
        hh, ww = gray.shape
        ii = _integral(gray)
        ii2 = _integral(gray**2)
        base_h, base_w = self.m.window
        hits = []
        scale = max(min_size / base_w, 1.0)
        while base_w * scale < ww and base_h * scale < hh:
            win_w = int(base_w * scale)
            win_h = int(base_h * scale)
            step = max(2, int(win_w * step_frac))
            ys, xs = np.meshgrid(
                np.arange(0, hh - win_h, step),
                np.arange(0, ww - win_w, step),
                indexing="ij",
            )
            ys = ys.reshape(-1)
            xs = xs.reshape(-1)
            if len(ys) > max_windows:
                scale *= scale_factor
                continue
            # variance normalization over the scaled norm rect (OpenCV uses
            # Rect(1, 1, w-2, h-2)): nf = sqrt(area * sum(x^2) - sum(x)^2)
            nx = xs + int(round(scale))
            ny = ys + int(round(scale))
            nw = int((base_w - 2) * scale)
            nh = int((base_h - 2) * scale)
            area = float(nw * nh)
            s1 = (ii[ny + nh, nx + nw] - ii[ny, nx + nw]
                  - ii[ny + nh, nx] + ii[ny, nx])
            s2 = (ii2[ny + nh, nx + nw] - ii2[ny, nx + nw]
                  - ii2[ny + nh, nx] + ii2[ny, nx])
            nf = area * s2 - s1**2
            inv_norm = 1.0 / np.sqrt(np.maximum(nf, 1.0))

            # pre-scale feature rects; rebalance the base-rect weight so the
            # weighted areas still cancel after integer flooring (OpenCV's
            # computeOptFeatures does the same).
            rs = self.m.rects.copy()
            rs[:, :, :4] = np.floor(rs[:, :, :4] * scale)
            areas = rs[:, :, 2] * rs[:, :, 3]
            tail = (rs[:, 1:, 4] * areas[:, 1:]).sum(axis=1)
            rs[:, 0, 4] = -tail / np.maximum(areas[:, 0], 1.0)
            active = np.arange(len(ys))
            ay, ax, anorm = ys, xs, inv_norm
            for stage in self.m.stages:
                if len(active) == 0:
                    break
                score = np.zeros(len(active), np.float64)
                for internal, leaves in stage.trees:
                    # evaluate the (tiny) tree per window
                    node = np.zeros(len(active), np.int64)
                    out = np.full(len(active), np.nan)
                    pending = np.ones(len(active), bool)
                    for _ in range(len(internal) + 1):
                        if not pending.any():
                            break
                        idxs = np.where(pending)[0]
                        nodes = node[idxs]
                        feat_idx = internal[nodes, 2].astype(int)
                        thr = internal[nodes, 3]
                        fv = np.empty(len(idxs))
                        for fi in np.unique(feat_idx):
                            m = feat_idx == fi
                            fv[m] = _rect_sums(ii, ay[idxs[m]], ax[idxs[m]],
                                               rs[fi]) * anorm[idxs[m]]
                        branch = np.where(fv < thr, internal[nodes, 0],
                                          internal[nodes, 1]).astype(int)
                        # OpenCV DTree encoding: idx > 0 -> internal node,
                        # idx <= 0 -> leafValues[-idx]
                        is_leaf = branch <= 0
                        out[idxs[is_leaf]] = leaves[-branch[is_leaf]]
                        node[idxs[~is_leaf]] = branch[~is_leaf]
                        pending[idxs[is_leaf]] = False
                    score += out
                keep = score >= stage.threshold
                active = active[keep]
                ay, ax, anorm = ay[keep], ax[keep], anorm[keep]
            for y, x in zip(ay, ax):
                hits.append((int(x), int(y), win_w, win_h))
            scale *= scale_factor
        return _merge_boxes(hits)


def _merge_boxes(boxes: Sequence[Tuple[int, int, int, int]],
                 min_neighbors: int = 2, iou_thr: float = 0.3):
    """Group overlapping detections; keep clusters with enough neighbors."""
    if not boxes:
        return []
    boxes = np.array(boxes, np.float64)
    used = np.zeros(len(boxes), bool)
    out = []
    for i in range(len(boxes)):
        if used[i]:
            continue
        xi, yi, wi, hi = boxes[i]
        x2i, y2i = xi + wi, yi + hi
        xx1 = np.maximum(xi, boxes[:, 0])
        yy1 = np.maximum(yi, boxes[:, 1])
        xx2 = np.minimum(x2i, boxes[:, 0] + boxes[:, 2])
        yy2 = np.minimum(y2i, boxes[:, 1] + boxes[:, 3])
        inter = np.maximum(0, xx2 - xx1) * np.maximum(0, yy2 - yy1)
        union = wi * hi + boxes[:, 2] * boxes[:, 3] - inter
        iou = inter / np.maximum(union, 1)
        members = np.where((iou > iou_thr) & ~used)[0]
        if len(members) >= min_neighbors:
            used[members] = True
            m = boxes[members]
            out.append(tuple(m.mean(axis=0).astype(int)))
    return out
