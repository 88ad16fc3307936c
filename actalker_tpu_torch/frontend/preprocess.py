"""Reference-image preprocessing on the host, the port's own copy of
``actalker_tpu/frontend/preprocess.py`` (the reference's
``src/dataset/test_preprocess.py:202-468``): the face box (from any
detector; the full image when there is none, as the reference falls back),
the area-expanded white-box pose mask, the mouth mask (the lower half from
the reference's ``y1 + y2 // 2``), the expression mask (pose - mouth), the
64-multiple short-edge resize, and the square / aspect crop helpers
(``process_bbox`` / ``get_bbox_by_aspect``,
``portrait_audio_dataset_arcface_vasa.py:343-400, 26-58``).

Images are channel-last numpy arrays. Resizing is PIL's LANCZOS where PIL
is installed, else the JAX package's nearest-neighbour fallback, announced
once on stderr. ``read_image`` reads a portrait through PIL or the native
libav runtime.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Optional, Tuple

import numpy as np

from actalker_tpu_torch.frontend import media_native

try:
    from PIL import Image

    HAVE_PIL = True
except ImportError:
    HAVE_PIL = False

_WARNED = []


def expand_bbox(bbox, ratio, height, width):
    x1, y1, x2, y2 = bbox
    bh, bw = y2 - y1, x2 - x1
    return [max(x1 - ratio * bw, 0), max(y1 - ratio * bh, 0),
            min(x2 + ratio * bw, width), min(y2 + ratio * bh, height)]


def to_square(bbox_src, bbox_exp, height, width):
    h = bbox_exp[3] - bbox_exp[1]
    w = bbox_exp[2] - bbox_exp[0]
    c_h = (bbox_exp[1] + bbox_exp[3]) / 2
    c_w = (bbox_exp[0] + bbox_exp[2]) / 2
    c = min(h, w) / 2
    c_src_h = (bbox_src[1] + bbox_src[3]) / 2
    c_src_w = (bbox_src[0] + bbox_src[2]) / 2
    s_h = s_w = 0.0
    d = abs((h - w) / 2)
    if w < h:
        s_h = min(d, abs(c_src_h - c_h))
        s_h = s_h if c_src_h > c_h else -s_h
    else:
        s_w = min(d, abs(c_src_w - c_w))
        s_w = s_w if c_src_w > c_w else -s_w
    c_h += s_h
    c_w += s_w
    return [round(c_w - c), round(c_h - c), round(c_w + c), round(c_h + c)]


def process_bbox(bbox, expand_ratio, height, width):
    """Expanded square crop box centered toward the source bbox."""
    return to_square(bbox, expand_bbox(bbox, expand_ratio, height, width),
                     height, width)


def get_bbox_by_aspect(bbox_s, aspect_type, w, h):
    x1, y1, x2, y2 = bbox_s
    ww, hh = x2 - x1, y2 - y1
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    if aspect_type == "1:1":
        ww = hh = min(ww, hh)
        x1, x2 = round(cx - ww / 2), round(cx + ww / 2)
        y1, y2 = round(cy - hh / 2), round(cy + hh / 2)
    elif aspect_type == "16:9":
        ww = hh / 9 * 16
        x1, x2 = round(cx - ww / 2), round(cx + ww / 2)
        if x1 < 0:
            x2 -= x1
            x1 = 0
        if x2 > w:
            x1 = max(0, x1 - (x2 - w))
            x2 = w
    elif aspect_type == "9:16":
        hh = ww / 9 * 16
        y1, y2 = y1, round(y1 + hh)
        if y2 > h:
            y1 = max(0, y1 - (y2 - h))
            y2 = h
    else:
        raise NotImplementedError(aspect_type)
    return [x1, y1, x2, y2]


def resize_to_64_multiple(img: np.ndarray, image_size: int) -> np.ndarray:
    """Short-edge resize to ``image_size``, both sides rounded to
    multiples of 64."""
    h, w = img.shape[:2]
    scale = image_size / min(w, h)
    return resize_image(img, (round(h * scale / 64) * 64,
                              round(w * scale / 64) * 64))


def resize_image(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """LANCZOS resize to (H, W) through PIL; without PIL, nearest
    neighbour (the JAX package's fallback), said once on stderr."""
    nh, nw = hw
    if HAVE_PIL:
        arr = img if img.dtype == np.uint8 else np.clip(img, 0, 255).astype(np.uint8)
        out = np.asarray(Image.fromarray(arr, "L" if arr.ndim == 2 else "RGB")
                         .resize((nw, nh), Image.LANCZOS))
        return out.astype(img.dtype) if img.dtype != np.uint8 else out
    if not _WARNED:
        _WARNED.append(True)
        print("[actalker_tpu_torch] PIL is not installed: images are resized "
              "by nearest neighbour, not LANCZOS", file=sys.stderr)
    ys = (np.arange(nh) * img.shape[0] / nh).astype(int)
    xs = (np.arange(nw) * img.shape[1] / nw).astype(int)
    return img[ys][:, xs]


def read_image(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB through PIL, else the native libav runtime."""
    if HAVE_PIL:
        return np.asarray(Image.open(path).convert("RGB"))
    if media_native.lib() is not None:
        return media_native.read_video(path, limit=1)[0]
    raise RuntimeError(f"{path}: no image decoder (install PIL or build "
                       "runtime/libactalker_media.so)")


@dataclasses.dataclass
class PreprocessedImage:
    ref_img: np.ndarray      # (H, W, 3) in [-1, 1]
    pose_img: np.ndarray     # (H, W, 3) box mask in [0, 1]
    mouth_mask: np.ndarray   # (H, W, 3)
    exp_mask: np.ndarray     # (H, W, 3)
    head_crop: np.ndarray    # (112, 112, 3) in [-1, 1] for ArcFace
    bbox: Tuple[float, float, float, float]
    # the face box in ref_img's pixels (after the crop and the resize)
    bbox_ref: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)


def preprocess_reference_image(
    image: np.ndarray,              # (H, W, 3) uint8 RGB
    face_bbox: Optional[Tuple[float, float, float, float]] = None,
    image_size: int = 512,
    area: float = 1.25,
    crop: bool = False,
    expand_ratio: float = 1.0,
    aspect_type: str = "1:1",
) -> PreprocessedImage:
    """The reference tensor and its region box masks. ``face_bbox`` is (x1,
    y1, x2, y2) from any detector; None takes the full image."""
    h, w = image.shape[:2]
    if face_bbox is None:
        face_bbox = (0.0, 0.0, float(w), float(h))
    x1, y1, x2, y2 = face_bbox

    head = image[int(y1):int(max(y2, y1 + 1)), int(x1):int(max(x2, x1 + 1))]
    head_crop = resize_image(head, (112, 112)).astype(np.float32) / 255.0
    head_crop = head_crop * 2.0 - 1.0

    # the area-expanded white box (the "pose image")
    ww, hh = (x2 - x1) * area, (y2 - y1) * area
    cx, cy = (x2 + x1) // 2, (y2 + y1) // 2
    bx1, by1 = max(cx - ww // 2, 0), max(cy - hh // 2, 0)
    bx2, by2 = min(cx + ww // 2, w), min(cy + hh // 2, h)
    pose = np.zeros_like(image)
    pose[int(by1):int(by2), int(bx1):int(bx2)] = 255
    mouth = np.zeros_like(image)
    # the reference's lower-half start, y1 + y2 // 2, kept
    mouth[(int(by1) + int(by2) // 2):int(by2), int(bx1):int(bx2)] = 255
    exp = pose - mouth

    img = image
    off_x = off_y = 0.0
    if crop:
        bbox_s = process_bbox([bx1, by1, bx2, by2], expand_ratio, h, w)
        cx1, cy1, cx2, cy2 = get_bbox_by_aspect(bbox_s, aspect_type, w, h)
        img = img[cy1:cy2, cx1:cx2]
        pose = pose[cy1:cy2, cx1:cx2]
        mouth = mouth[cy1:cy2, cx1:cx2]
        exp = exp[cy1:cy2, cx1:cx2]
        off_x, off_y = float(cx1), float(cy1)

    ih, iw = img.shape[:2]
    ref = resize_to_64_multiple(img, image_size).astype(np.float32) / 255.0
    ref = ref * 2.0 - 1.0
    pose = resize_to_64_multiple(pose, image_size).astype(np.float32) / 255.0
    mouth = resize_to_64_multiple(mouth, image_size).astype(np.float32) / 255.0
    exp = resize_to_64_multiple(exp, image_size).astype(np.float32) / 255.0
    sy, sx = ref.shape[0] / ih, ref.shape[1] / iw
    bbox_ref = ((x1 - off_x) * sx, (y1 - off_y) * sy,
                (x2 - off_x) * sx, (y2 - off_y) * sy)
    return PreprocessedImage(
        ref_img=ref, pose_img=pose, mouth_mask=mouth, exp_mask=exp,
        head_crop=head_crop, bbox=face_bbox, bbox_ref=bbox_ref)
