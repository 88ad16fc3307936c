"""Face detection on the host, the port's own copy of
``actalker_tpu/frontend/face.py``.

The detector is pluggable (``FaceDetector``: any callable ``image -> (x1,
y1, x2, y2) | None``); a None result falls back to the full image, as the
reference does without its alignment models (``test_preprocess.py:222-225``).
``resolve_face_detector`` takes the reference's order (``align.py:270-274``):
YOLOv5-face where its checkpoint exists, else SCRFD-10G-bnkps, else the
Viola-Jones cascade over OpenCV's Haar models, with a warning.
"""
from __future__ import annotations

import os
import sys
from typing import Optional, Protocol, Tuple

import numpy as np

Box = Tuple[float, float, float, float]


class NoCascadeModelError(RuntimeError):
    """The system has no Haar cascade model for the Viola-Jones detector."""


class FaceDetector(Protocol):
    def __call__(self, image: np.ndarray) -> Optional[Box]: ...


class CascadeFaceDetector:
    """Viola-Jones over the system's Haar cascade models."""

    CASCADE_PATHS = (
        "/usr/share/opencv4/haarcascades/haarcascade_frontalface_alt2.xml",
        "/usr/share/opencv4/haarcascades/haarcascade_frontalface_default.xml",
    )

    def __init__(self, max_side: int = 320):
        from actalker_tpu_torch.frontend.viola_jones import CascadeModel, ViolaJones

        path = next((p for p in self.CASCADE_PATHS if os.path.exists(p)), None)
        if path is None:
            raise NoCascadeModelError("no haarcascade model found on this system")
        self.vj = ViolaJones(CascadeModel.load(path))
        self.max_side = max_side

    def __call__(self, image: np.ndarray) -> Optional[Box]:
        h, w = image.shape[:2]
        ds = max(1, int(np.ceil(max(h, w) / self.max_side)))
        small = image[::ds, ::ds]
        gray = (0.299 * small[..., 0] + 0.587 * small[..., 1]
                + 0.114 * small[..., 2])
        faces = self.vj.detect(gray, min_size=max(24, min(gray.shape) // 8))
        if not faces:
            return None
        x, y, fw, fh = max(faces, key=lambda f: f[2] * f[3])  # the largest
        return (float(x * ds), float(y * ds),
                float((x + fw) * ds), float((y + fh) * ds))


def detect_face(image: np.ndarray,
                detector: Optional[FaceDetector] = None) -> Optional[Box]:
    """The detector's box, or None (no face, no detector, or the image is
    one the host code rejects). A device error propagates."""
    if detector is None:
        try:
            detector = CascadeFaceDetector()
        except NoCascadeModelError:
            return None
    try:
        return detector(image)
    except (ValueError, IndexError):
        return None


def resolve_face_detector(det_path: str = "", scrfd_path: str = "",
                          device="cuda") -> FaceDetector:
    """The best detector available: YOLOv5-face from ``det_path``, else
    SCRFD-10G-bnkps from ``scrfd_path`` (each on ``device``, fp32), else the
    Viola-Jones cascade with a warning (its boxes are markedly less accurate).
    Raises NoCascadeModelError where it comes to the cascade and the system
    has no cascade model."""
    from actalker_tpu_torch.io import init

    if det_path and os.path.exists(det_path):
        from actalker_tpu_torch.models.yoloface import YoloFaceDetector

        return YoloFaceDetector(init.load_yoloface(det_path, device))
    if scrfd_path and os.path.exists(scrfd_path):
        from actalker_tpu_torch.models.scrfd import ScrfdDetector

        return ScrfdDetector(init.load_scrfd(scrfd_path, device))
    print("[actalker_tpu_torch] WARNING: no face-detector checkpoint (yoloface "
          f"at {det_path or '<unset>'}, scrfd at {scrfd_path or '<unset>'}): "
          "face boxes come from the Viola-Jones cascade, and boxes, region "
          "masks, the ArcFace crop and the BFR alignment are markedly less "
          "accurate than the reference's", file=sys.stderr)
    return CascadeFaceDetector()
