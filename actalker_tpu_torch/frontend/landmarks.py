"""5-point facial landmarks on the host, the port's own copy of
``actalker_tpu/frontend/landmarks.py``. The 5-point layout is (left eye,
right eye, nose, left mouth corner, right mouth corner), which
``frontend/enhance.py`` aligns on. The reference's landmarkers (MediaPipe,
its two-phase TorchScript regressors) are not in this tree; in their place,
best first (``resolve_landmark_estimator``):

  * ``RTMFaceLandmarker``: a dense RTMPose face head (RTMPose-m face6, 106
    LaPa points, 256 x 256) reduced to 5 points;
  * ``YoloFaceLandmarks``: the 5 points a learned detector (YOLOv5-face or
    SCRFD) regresses beside its box;
  * ``LandmarkEstimator``: Haar eye / smile cascades where the system has
    their models, else the face box's geometry prior.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from actalker_tpu_torch.frontend.enhance import box_to_landmarks

Box = Tuple[float, float, float, float]

_EYE_XML = "/usr/share/opencv4/haarcascades/haarcascade_eye.xml"
_SMILE_XML = "/usr/share/opencv4/haarcascades/haarcascade_smile.xml"


class LandmarkEstimator:
    """Eyes and mouth from the Viola-Jones part cascades, the nose between
    them; each part not found keeps the box prior (all of them where the
    cascade models are absent)."""

    def __init__(self):
        from actalker_tpu_torch.frontend.viola_jones import CascadeModel, ViolaJones

        self.eye = (ViolaJones(CascadeModel.load(_EYE_XML))
                    if os.path.exists(_EYE_XML) else None)
        self.smile = (ViolaJones(CascadeModel.load(_SMILE_XML))
                      if os.path.exists(_SMILE_XML) else None)

    @staticmethod
    def _gray(image: np.ndarray) -> np.ndarray:
        if image.ndim == 3:
            return 0.299 * image[..., 0] + 0.587 * image[..., 1] + 0.114 * image[..., 2]
        return image.astype(np.float64)

    def __call__(self, image: np.ndarray, face_box: Box) -> np.ndarray:
        """(H, W[, 3]) image + face box -> (5, 2) landmarks."""
        lm = box_to_landmarks(face_box).astype(np.float64)
        x1, y1, x2, y2 = [int(round(v)) for v in face_box]
        h, w = image.shape[:2]
        x1, y1, x2, y2 = max(0, x1), max(0, y1), min(w, x2), min(h, y2)
        if x2 - x1 < 24 or y2 - y1 < 24:
            return lm.astype(np.float32)
        gray = self._gray(image[y1:y2, x1:x2])
        fw, fh = x2 - x1, y2 - y1
        if self.eye is not None:
            # the eyes lie in the upper half, one a side
            upper, half = gray[: fh // 2], fw // 2
            for side, (xo, sl) in enumerate(((0, upper[:, :half]), (half, upper[:, half:]))):
                dets = self.eye.detect(sl, min_size=max(12, fw // 8), scale_factor=1.15)
                if dets:
                    ex, ey, ew, eh = max(dets, key=lambda d: d[2] * d[3])
                    lm[side] = (x1 + xo + ex + ew / 2.0, y1 + ey + eh / 2.0)
        if self.smile is not None:
            dets = self.smile.detect(gray[fh // 2:], min_size=max(16, fw // 6),
                                     scale_factor=1.15)
            if dets:
                mx, my, mw, mh = max(dets, key=lambda d: d[2] * d[3])
                cy = y1 + fh // 2 + my + mh / 2.0
                lm[3] = (x1 + mx + 0.15 * mw, cy)
                lm[4] = (x1 + mx + 0.85 * mw, cy)
        lm[2] = (lm[0] + lm[1]) / 2.0 * 0.5 + (lm[3] + lm[4]) / 2.0 * 0.5
        return lm.astype(np.float32)


class NoFaceError(RuntimeError):
    """The detector found no face where landmarks were asked for."""


class YoloFaceLandmarks:
    """The 5 points of a learned detector's best match to the box: any
    ``detect(bgr) -> (xywh boxes, (N, 5, 2) kps, scores)``
    (``models/yoloface.py``, ``models/scrfd.py``)."""

    def __init__(self, detector):
        self.detector = detector

    def __call__(self, image: np.ndarray, face_box: Box) -> np.ndarray:
        bboxes, kpss, scores = self.detector.detect(np.ascontiguousarray(image[..., ::-1]))
        if len(bboxes) == 0:
            raise NoFaceError("the detector found no face")
        # the detection that overlaps the requested box most, by score
        x1, y1, x2, y2 = face_box
        bx1, by1 = bboxes[:, 0], bboxes[:, 1]
        bx2, by2 = bx1 + bboxes[:, 2], by1 + bboxes[:, 3]
        iw = np.maximum(0, np.minimum(bx2, x2) - np.maximum(bx1, x1))
        ih = np.maximum(0, np.minimum(by2, y2) - np.maximum(by1, y1))
        return kpss[int(np.argmax(iw * ih * scores))].astype(np.float32)


# index groups reducing a dense landmark set to the 5 points (means over each
# group). LaPa-106, the layout of mmpose's RTMPose face6 models: contour
# 0-32, brows 33-50, nose 51-65 (tip 54), eye rings 66-74 / 75-83, mouth
# 84-103 (outer corners 84 / 90), pupils 104 / 105
LAPA_106_TO_5 = (tuple(range(66, 75)), tuple(range(75, 84)), (54,), (84,), (90,))


class RTMFaceLandmarker:
    """Dense face landmarks from an RTMPose / SimCC head (the top-down crop
    and SimCC decode of ``models/rtmpose.py``), reduced to 5 points by
    the LaPa-106 groups; ``dense()`` gives all K."""

    def __init__(self, net):
        from actalker_tpu_torch.models.rtmpose import RTMPoseWholebody

        self.engine = RTMPoseWholebody(net)

    def dense(self, image: np.ndarray, face_box: Box):
        """(K, 2) landmarks in source pixels and their (K,) scores."""
        kpts, scores = self.engine(np.ascontiguousarray(image[..., ::-1]), [list(face_box)])
        return kpts[0], scores[0]

    def __call__(self, image: np.ndarray, face_box: Box) -> np.ndarray:
        kpts, _ = self.dense(image, face_box)
        return np.stack([kpts[list(g)].mean(axis=0) for g in LAPA_106_TO_5]
                        ).astype(np.float32)


def face6_config():
    """RTMPose-m face6: widen 0.75, deepen 0.67, 106 keypoints, 256 x 256."""
    from actalker_tpu_torch.models.rtmpose import RTMPoseConfig

    return RTMPoseConfig(widen=0.75, deepen=0.67, num_keypoints=106,
                         input_size=(256, 256))


def resolve_landmark_estimator(det_path: str = "", scrfd_path: str = "",
                               face_landmark_path: str = "", device="cuda"):
    """The best landmarker available: the RTMPose face head where its
    checkpoint exists, then a learned detector's keypoints (YOLOv5-face,
    then SCRFD), else the cascade estimator. Networks load on ``device``
    (fp32)."""
    from actalker_tpu_torch.io.init import load_face_landmarker

    if face_landmark_path and os.path.exists(face_landmark_path):
        return RTMFaceLandmarker(load_face_landmarker(face_landmark_path, device))
    if any(p and os.path.exists(p) for p in (det_path, scrfd_path)):
        from actalker_tpu_torch.frontend.face import resolve_face_detector

        return YoloFaceLandmarks(resolve_face_detector(det_path, scrfd_path, device))
    return LandmarkEstimator()
