"""Face detection on the host, the port's own copy of
``actalker_tpu/frontend/face.py``.

The detector is pluggable (``FaceDetector``: any callable ``image -> (x1,
y1, x2, y2) | None``); a None result falls back to the full image, as the
reference does without its alignment models (``test_preprocess.py:222-225``).
``resolve_face_detector`` gives the Viola-Jones cascade over OpenCV's Haar
models. The learned detectors of the JAX package (YOLOv5-face, SCRFD) are
not ported yet: a configured checkpoint of theirs is reported and the
cascade serves instead.
"""
from __future__ import annotations

import os
import sys
from typing import Optional, Protocol, Tuple

import numpy as np

Box = Tuple[float, float, float, float]


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
            raise RuntimeError("no haarcascade model found on this system")
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
    """The detector's box, or None (no face, no detector, or it failed)."""
    if detector is None:
        try:
            detector = CascadeFaceDetector()
        except RuntimeError:
            return None
    try:
        return detector(image)
    except (RuntimeError, ValueError, IndexError):
        return None


def resolve_face_detector(det_path: str = "",
                          scrfd_path: str = "") -> FaceDetector:
    """The Viola-Jones cascade, with a warning: its boxes are markedly less
    accurate than the reference's learned detectors, whose ports wait
    (configured checkpoints of theirs are named in the warning). Raises
    RuntimeError where the system has no cascade model."""
    pending = [p for p in (det_path, scrfd_path) if p and os.path.exists(p)]
    print("[actalker_tpu_torch] WARNING: face boxes come from the Viola-Jones "
          "cascade" + (f"; the learned detectors of {pending} are not ported "
                       "yet" if pending else "")
          + ": boxes, region masks and the ArcFace crop are less accurate "
          "than the reference's", file=sys.stderr)
    return CascadeFaceDetector()
