"""Training-data curation: raw clips -> the clip metadata JSON that
``training/data.py::load_metadata`` reads. The port's copy of
``tools/curate_data.py`` (the reference's curation tree,
``utils/data_preprocess.py``, and the quality gating of its dataset).

    python -m actalker_tpu_torch.tools.curate_data OUT.json CLIP [CLIP...]
        [--stride 1] [--max-frames 300] [--min-quality 0.0]
        [--yoloface yolov5m-face.pth] [--npy-fps 25.0] [--device cuda|cpu]

One record a clip: ``video_path``, ``audio_path``, ``frames``, ``fps``,
``bboxes`` ([x1, y1, x2, y2] a frame), ``landmarks`` (5 [x, y] a frame),
``quality`` (the median over frames of the face crop's Laplacian variance
times min(1, 4 x the box's share of the frame)) and ``motion_bucket``
(Farneback over the first 16 frames, ``frontend/optical_flow.py``).

A clip is a video file (decoded by ``frontend/video.py``; its audio is
the muxed track) or a ``.npy`` stack of (T, H, W, 3) uint8 RGB frames with
``<stem>.wav`` beside it, at ``--npy-fps`` (for a machine without a video
decoder). Detection is the Viola-Jones cascade by default (a frame without
a face keeps the whole frame as its box, and pseudo-landmarks from it);
``--yoloface`` takes the reference's yolov5-face file
(``io/init.load_yoloface``, fp32 on ``--device``), whose one pass a frame
gives both the box and the 5 landmarks; there a frame without a face drops
the clip. A clip is dropped, with the reason on stderr, when it cannot be
read, has fewer than 2 frames, or has a frame without a face; anything
else raises.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


class ClipError(Exception):
    """A clip this tool cannot curate (unreadable, too short, no face)."""


def laplacian_sharpness(gray: np.ndarray) -> float:
    """Variance of the Laplacian: the blur gate."""
    lap = (-4.0 * gray[1:-1, 1:-1] + gray[:-2, 1:-1] + gray[2:, 1:-1]
           + gray[1:-1, :-2] + gray[1:-1, 2:])
    return float(lap.var())


def read_clip(path: str, limit: int, npy_fps: float):
    """(frames (T, H, W, 3) uint8 RGB, fps, audio path) of a video file or
    a ``.npy`` stack; an unreadable clip raises ClipError."""
    if path.endswith(".npy"):
        wav = os.path.splitext(path)[0] + ".wav"
        if not os.path.exists(wav):
            raise ClipError(f"no {os.path.basename(wav)} beside the frame stack")
        try:
            frames = np.asarray(np.load(path, mmap_mode="r")[:limit])
        except (OSError, ValueError) as e:
            raise ClipError(f"unreadable frame stack: {e}") from e
        if frames.ndim != 4 or frames.shape[-1] != 3 or frames.dtype != np.uint8:
            raise ClipError(f"a frame stack of {frames.dtype} {frames.shape}, not "
                            "(T, H, W, 3) uint8")
        return frames, float(npy_fps), wav
    from actalker_tpu_torch.frontend import video as V

    if not os.path.exists(path):
        raise ClipError("no such file")
    try:
        frames = V.read_frames(path, limit=limit)
    except (RuntimeError, OSError) as e:       # no decoder, no video stream
        raise ClipError(f"unreadable video: {e}") from e
    return frames, float(V.get_fps(path)), path


def curate_clip(path: str, detector, landmarker, stride: int = 1,
                max_frames: int = 300, npy_fps: float = 25.0) -> dict:
    """One clip's record; ``detector(rgb) -> box | None``,
    ``landmarker(rgb, box) -> (5, 2)`` or None (landmarks from the box)."""
    from actalker_tpu_torch.frontend.enhance import box_to_landmarks
    from actalker_tpu_torch.training.data import motion_bucket_from_flow

    frames, fps, audio = read_clip(path, max_frames * stride, npy_fps)
    frames = frames[::stride]
    if len(frames) < 2:
        raise ClipError(f"{len(frames)} frame(s); a clip needs 2")
    bboxes, landmarks, quality = [], [], []
    h, w = frames[0].shape[:2]
    for fr in frames:
        box = detector(fr) if detector is not None else None
        if box is None:
            box = (0.0, 0.0, float(w), float(h))
        bboxes.append([float(v) for v in box])
        lm = landmarker(fr, box) if landmarker is not None else box_to_landmarks(box)
        landmarks.append(np.asarray(lm, np.float32).tolist())
        x1, y1, x2, y2 = box
        crop = fr[int(max(0, y1)):int(min(h, y2)), int(max(0, x1)):int(min(w, x2))]
        if crop.size == 0:
            quality.append(0.0)
            continue
        gray = 0.299 * crop[..., 0] + 0.587 * crop[..., 1] + 0.114 * crop[..., 2]
        coverage = (x2 - x1) * (y2 - y1) / float(h * w)
        quality.append(laplacian_sharpness(gray) * min(1.0, 4.0 * coverage))
    return {
        "video_path": os.path.abspath(path),
        "audio_path": os.path.abspath(audio),
        "frames": len(frames),
        "fps": fps / stride,
        "bboxes": bboxes,
        "landmarks": landmarks,
        "quality": float(np.median(quality)),
        "motion_bucket": int(motion_bucket_from_flow(frames[:min(len(frames), 16)])),
    }


class YoloFaceOnce:
    """A yolov5-face detector's box and 5 landmarks from one network pass a
    frame (RGB in; the detector takes BGR): ``box(rgb)`` the best-scoring
    box or None, ``landmarks(rgb, box)`` the points of the detection that
    best overlaps ``box`` by score. ``passes`` counts the network's
    passes."""

    def __init__(self, det):
        self.det = det
        self.passes = 0
        self._key, self._out = None, None

    def _detect(self, rgb: np.ndarray):
        if self._key is not rgb:
            self._key, self._out = rgb, self.det.detect(rgb[..., ::-1])
            self.passes += 1
        return self._out

    def box(self, rgb: np.ndarray):
        bboxes, _, scores = self._detect(rgb)
        if len(bboxes) == 0:
            return None
        x, y, bw, bh = bboxes[np.argmax(scores)]
        return (float(x), float(y), float(x + bw), float(y + bh))

    def landmarks(self, rgb: np.ndarray, box) -> np.ndarray:
        bboxes, kpss, scores = self._detect(rgb)
        if len(bboxes) == 0:
            raise ClipError("a frame without a face")
        x1, y1, x2, y2 = box
        bx1, by1 = bboxes[:, 0], bboxes[:, 1]
        bx2, by2 = bx1 + bboxes[:, 2], by1 + bboxes[:, 3]
        iw = np.maximum(0, np.minimum(bx2, x2) - np.maximum(bx1, x1))
        ih = np.maximum(0, np.minimum(by2, y2) - np.maximum(by1, y1))
        return kpss[int(np.argmax(iw * ih * scores))].astype(np.float32)


def main(argv=None) -> dict:
    """Curate; writes OUT.json and returns {"clips", "dropped", "detector"}
    (the detector object, for its pass count)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out")
    ap.add_argument("clips", nargs="+")
    ap.add_argument("--stride", type=int, default=1)
    ap.add_argument("--max-frames", type=int, default=300)
    ap.add_argument("--min-quality", type=float, default=0.0)
    ap.add_argument("--yoloface", default=None,
                    help="the reference's yolov5-face file (boxes and landmarks); "
                         "default: the Viola-Jones cascade")
    ap.add_argument("--npy-fps", type=float, default=25.0,
                    help="the frame rate of .npy frame stacks")
    ap.add_argument("--device", default="cuda",
                    help="where the yolov5-face network runs (cuda needs a card)")
    args = ap.parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to curate on the CPU")
    detector, landmarker, once = None, None, None
    if args.yoloface:
        from actalker_tpu_torch.io.init import load_yoloface
        from actalker_tpu_torch.models.yoloface import YoloFaceDetector

        once = YoloFaceOnce(YoloFaceDetector(load_yoloface(args.yoloface, device)))
        detector, landmarker = once.box, once.landmarks
    else:
        from actalker_tpu_torch.frontend.face import (
            CascadeFaceDetector, NoCascadeModelError, detect_face)

        try:
            cascade = CascadeFaceDetector()
            detector = lambda img: detect_face(img, cascade)  # noqa: E731
        except NoCascadeModelError as e:
            print(f"[curate] {e}: every box is the whole frame", file=sys.stderr)

    clips, dropped = [], 0
    for path in args.clips:
        try:
            rec = curate_clip(path, detector, landmarker, stride=args.stride,
                              max_frames=args.max_frames, npy_fps=args.npy_fps)
        except ClipError as e:
            print(f"[curate] skip {path}: {e}", file=sys.stderr)
            rec = None
        if rec is None or rec["quality"] < args.min_quality:
            dropped += 1
            continue
        clips.append(rec)
    with open(args.out, "w") as f:
        json.dump(clips, f)
    print(f"[curate] wrote {len(clips)} clips to {args.out} ({dropped} dropped)")
    return {"clips": clips, "dropped": dropped, "detector": once}


if __name__ == "__main__":
    main()
