"""Video IO on the host, the port's own copy of
``actalker_tpu/frontend/video.py``: the native libav runtime
(``media_native``) first, then the ``ffmpeg`` binary (the reference's
writer, ``src/utils/ffmpeg_utils.py``); with neither, a clear error."""
from __future__ import annotations

import shutil
import subprocess
from typing import Optional

import numpy as np

from actalker_tpu_torch.frontend import media_native


def have_encoder() -> bool:
    """Whether ``write_video`` has an encoder on this machine."""
    return media_native.lib() is not None or shutil.which("ffmpeg") is not None


def read_frames(path: str, limit: Optional[int] = None) -> np.ndarray:
    """(F, H, W, 3) uint8 RGB frames, at most ``limit``."""
    if media_native.lib() is not None:
        return media_native.read_video(path, limit=limit)
    if not shutil.which("ffmpeg"):
        raise RuntimeError(
            "no video decoder available: build runtime/libactalker_media.so "
            "(make -C runtime) or install ffmpeg")
    probe = subprocess.run(
        ["ffmpeg", "-nostdin", "-i", path, "-vframes", "1", "-f", "rawvideo",
         "-pix_fmt", "rgb24", "-"], capture_output=True, check=True)
    import re

    m = re.search(rb"Stream .*Video: .*?(\d{2,5})x(\d{2,5})", probe.stderr)
    if m is None:
        raise RuntimeError(f"no video stream in {path}")
    w, h = int(m.group(1)), int(m.group(2))
    cmd = ["ffmpeg", "-nostdin", "-i", path]
    if limit:
        cmd += ["-vframes", str(limit)]
    out = subprocess.run(cmd + ["-f", "rawvideo", "-pix_fmt", "rgb24", "-"],
                         capture_output=True, check=True).stdout
    frames = np.frombuffer(out, np.uint8)
    n = len(frames) // (h * w * 3)
    if n == 0:
        raise RuntimeError(f"no frames decoded from {path}")
    return frames[:n * h * w * 3].reshape(n, h, w, 3).copy()


def write_video(path: str, frames: np.ndarray, fps: float = 12.5,
                crf: int = 17, audio_path: Optional[str] = None) -> None:
    """frames (F, H, W, 3) uint8 or [0, 1] float -> H.264 at crf 17 (the
    reference's writer, ``ffmpeg_utils.py:40-44``), with the audio of
    ``audio_path`` muxed as AAC when given."""
    if media_native.lib() is not None:
        media_native.write_video(path, frames, fps=fps, crf=crf,
                                 audio_path=audio_path)
        return
    if not shutil.which("ffmpeg"):
        raise RuntimeError(
            "no video encoder available: build runtime/libactalker_media.so "
            "(make -C runtime) or install ffmpeg")
    if frames.dtype != np.uint8:
        frames = (np.clip(frames, 0, 1) * 255).round().astype(np.uint8)
    _, h, w, _ = frames.shape
    cmd = ["ffmpeg", "-nostdin", "-y", "-f", "rawvideo", "-pix_fmt", "rgb24",
           "-s", f"{w}x{h}", "-r", str(fps), "-i", "-"]
    if audio_path:
        cmd += ["-i", audio_path, "-c:a", "aac", "-shortest"]
    cmd += ["-c:v", "libx264", "-crf", str(crf), "-pix_fmt", "yuv420p", path]
    res = subprocess.run(cmd, input=frames.tobytes(), stderr=subprocess.PIPE)
    if res.returncode != 0:
        raise RuntimeError(f"ffmpeg failed writing {path}: "
                           f"{res.stderr.decode(errors='replace')[-400:]}")
