"""Side-by-side result composer, twin of
``actalker_tpu/evaluation/compose.py`` (reference: ``eval/concate.py``).

The reference tool stitches each generated clip next to its driving
reference image (``eval/concate.py:28-59``: resize image to frame size,
``np.concatenate`` on width, re-mux the source audio) for qualitative
review sheets. Here the per-frame work is plain numpy over the port's host
video IO (``frontend/video.py``) — no PNG round-trip, no moviepy — and the
audio is muxed by its writer.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from actalker_tpu_torch.frontend import video as video_io


def _resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    from actalker_tpu_torch.frontend.preprocess import resize_image

    return resize_image(np.ascontiguousarray(img), (h, w))


def concat_video_with_image(video_path: str, image: np.ndarray,
                            out_path: str, fps: Optional[float] = None,
                            audio_path: Optional[str] = None) -> np.ndarray:
    """[ref image | generated frame] composite, written as one H.264 clip.

    ``image`` is (H, W, 3) uint8 RGB; it is resized to the clip's frame size
    (reference resizes the still to the frame, ``concate.py:35``).  Returns
    the composite frames (F, H, 2W, 3).
    """
    frames = video_io.read_frames(video_path)
    f, h, w = frames.shape[:3]
    still = _resize(image, h, w)
    composite = np.concatenate(
        [np.broadcast_to(still, (f, h, w, 3)), frames], axis=2)
    video_io.write_video(
        out_path, composite, fps=fps or video_io.get_fps(video_path),
        audio_path=audio_path or video_path)
    return composite


def concat_videos(paths: Sequence[str], out_path: str,
                  fps: Optional[float] = None,
                  audio_path: Optional[str] = None) -> np.ndarray:
    """Horizontal side-by-side of N clips (model-comparison sheets); clips
    are truncated to the shortest and resized to the first clip's height."""
    assert paths, "need at least one clip"
    clips = [video_io.read_frames(p) for p in paths]
    n = min(c.shape[0] for c in clips)
    h = clips[0].shape[1]
    cols = []
    for c in clips:
        c = c[:n]
        if c.shape[1] != h:
            w = int(round(c.shape[2] * h / c.shape[1]))
            c = np.stack([_resize(fr, h, w) for fr in c])
        cols.append(c)
    composite = np.concatenate(cols, axis=2)
    video_io.write_video(out_path, composite,
                         fps=fps or video_io.get_fps(paths[0]),
                         audio_path=audio_path or paths[0])
    return composite


def compose_result_dir(video_dir: str, image_dir: str, save_dir: str,
                       num: int = 20) -> list:
    """Directory driver matching ``eval/concate.py:62-90``: for each clip in
    ``video_dir`` whose basename has a ``<name>.png`` in ``image_dir``,
    write ``save_dir/<name>.mp4`` with the still composited on the left."""
    os.makedirs(save_dir, exist_ok=True)
    written = []
    for name in sorted(os.listdir(video_dir))[:num]:
        stem = os.path.splitext(name)[0]
        img_path = os.path.join(image_dir, stem + ".png")
        if not os.path.exists(img_path):
            continue
        import PIL.Image

        image = np.asarray(PIL.Image.open(img_path).convert("RGB"))
        out = os.path.join(save_dir, stem + ".mp4")
        concat_video_with_image(os.path.join(video_dir, name), image, out)
        written.append(out)
    return written
