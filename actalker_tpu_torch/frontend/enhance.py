"""Face restoration and teeth glue on the host, the port's own copy of
``actalker_tpu/frontend/enhance.py`` (the reference's
``src/utils/enhance/bfr_enhance.py`` and its call in
``test_preprocess.py:286-304``): a 5-point similarity transform to the
512 x 512 mean-face template, the restorer on the aligned crop, the inverse
warp and a feathered-mask composite averaged with the input; and the teeth
enhancer on a square mouth crop, alpha-composited back.

The image work is uint8 OpenCV glue, exact; the networks run behind a
callable (``generator_fn`` / ``teeth_fn``) on numpy arrays. The JAX
package's ``enhance_face`` warps its float64 feathered mask into a float32
``dst`` that OpenCV then leaves untouched, so its mask is zero and its
output the input; here the mask is float32 and the warps' returned arrays
are used. Without
detector landmarks, 5 pseudo-landmarks come from the face box, as the
reference does without its alignment models (``test_preprocess.py:295``).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

from actalker_tpu_torch.models.stylegan2 import feathered_box_mask

# the 512 px mean-face 5-point template (``test_preprocess.py:19-25``: the
# 256 px template, doubled)
MEAN_FACE_5P = np.array([
    [(30.2946 + 8) * 2 + 16, 51.6963 * 2],
    [(65.5318 + 8) * 2 + 16, 51.5014 * 2],
    [(48.0252 + 8) * 2 + 16, 71.7366 * 2],
    [(33.5493 + 8) * 2 + 16, 92.3655 * 2],
    [(62.7299 + 8) * 2 + 16, 92.2041 * 2],
], dtype=np.float32) * 2.0


def box_to_landmarks(box: Tuple[float, float, float, float]) -> np.ndarray:
    """Face box -> 5 pseudo-landmarks (eyes, nose, mouth corners)."""
    x1, y1, x2, y2 = box
    w, h = x2 - x1, y2 - y1
    return np.array([[x1 + 0.3 * w, y1 + 0.4 * h], [x1 + 0.7 * w, y1 + 0.4 * h],
                     [x1 + 0.5 * w, y1 + 0.55 * h], [x1 + 0.35 * w, y1 + 0.7 * h],
                     [x1 + 0.65 * w, y1 + 0.7 * h]], np.float32)


def similarity_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares similarity (rotation, scale, translation) src -> dst as
    a 2 x 3 affine (the reference's normal-equations solve,
    ``get_custom_affine_transform_512``)."""
    src = src.astype(np.float64)
    dst = dst.astype(np.float64)
    n = len(src)
    sxx = (src ** 2).sum()
    sx, sy = src[:, 0].sum(), src[:, 1].sum()
    b0 = (src[:, 0] * dst[:, 0] + src[:, 1] * dst[:, 1]).sum()
    b1 = (src[:, 0] * dst[:, 1] - src[:, 1] * dst[:, 0]).sum()
    A = np.array([[sxx, 0, sx, sy], [0, sxx, -sy, sx], [sx, -sy, n, 0],
                  [sy, sx, 0, n]])
    b = np.array([b0, b1, dst[:, 0].sum(), dst[:, 1].sum()])
    a, bb, tx, ty = np.linalg.lstsq(A, b, rcond=None)[0]
    return np.array([[a, -bb, tx], [bb, a, ty]], np.float32)


def enhance_face(image: np.ndarray, box: Tuple[float, float, float, float],
                 generator_fn: Callable[[np.ndarray], np.ndarray],
                 landmarks: Optional[np.ndarray] = None) -> np.ndarray:
    """BFR on the face of ``image`` ((H, W, 3) uint8 RGB). ``generator_fn``
    maps a (1, 512, 512, 3) crop in [-1, 1] to the restored crop;
    ``landmarks`` (5, 2) align it, else the box's geometry prior does. The
    composite is averaged with the input, as the reference's is."""
    import cv2

    h, w = image.shape[:2]
    lm = box_to_landmarks(box) if landmarks is None else np.asarray(landmarks)
    mat = similarity_transform(lm, MEAN_FACE_5P)
    crop = cv2.warpAffine(image, mat, (512, 512), flags=cv2.INTER_CUBIC)
    restored = np.asarray(generator_fn((crop.astype(np.float32) / 127.5 - 1.0)[None]))[0]
    restored = np.clip((restored + 1.0) * 127.5, 0, 255).astype(np.uint8)
    # BORDER_TRANSPARENT keeps dst where the warp has no source: the
    # results are the returned arrays (cv2 writes into dst only where its
    # type matches the source's)
    back = cv2.warpAffine(restored, mat, (w, h), dst=image.copy(),
                          flags=cv2.INTER_CUBIC | cv2.WARP_INVERSE_MAP,
                          borderMode=cv2.BORDER_TRANSPARENT)
    mask = cv2.warpAffine(feathered_box_mask(512).astype(np.float32), mat, (w, h),
                          dst=np.zeros((h, w), np.float32),
                          flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
                          borderMode=cv2.BORDER_TRANSPARENT)
    out = (image.astype(np.float32) * (1 - mask[..., None])
           + back.astype(np.float32) * mask[..., None])
    return ((out + image.astype(np.float32)) / 2.0).round().astype(np.uint8)


def enhance_teeth(image: np.ndarray, mouth_box: Tuple[float, float, float, float],
                  teeth_fn: Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray]]
                  ) -> np.ndarray:
    """The teeth enhancer on a square crop about ``mouth_box`` (1.2 x its
    longer side): ``teeth_fn`` maps (1, h, w, 3) in [-1, 1] to (rgb, alpha)
    at 512, which are resized back and alpha-composited onto ``image``
    ((H, W, 3) uint8 RGB)."""
    import cv2

    h, w = image.shape[:2]
    x1, y1, x2, y2 = mouth_box
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    half = max(x2 - x1, y2 - y1) / 2 * 1.2
    x1, x2 = int(max(0, cx - half)), int(min(w, cx + half))
    y1, y2 = int(max(0, cy - half)), int(min(h, cy + half))
    if x2 - x1 < 8 or y2 - y1 < 8:
        return image
    rgb, alpha = teeth_fn((image[y1:y2, x1:x2].astype(np.float32) / 127.5 - 1.0)[None])
    rgb = cv2.resize(np.clip((np.asarray(rgb)[0] + 1) * 127.5, 0, 255),
                     (x2 - x1, y2 - y1), interpolation=cv2.INTER_CUBIC)
    alpha = cv2.resize(np.asarray(alpha)[0], (x2 - x1, y2 - y1),
                       interpolation=cv2.INTER_LINEAR)[..., None]
    out = image.astype(np.float32)
    out[y1:y2, x1:x2] = out[y1:y2, x1:x2] * (1 - alpha) + rgb * alpha
    return out.round().astype(np.uint8)
