"""ctypes binding of the native media runtime (``runtime/libactalker_media.so``,
libavformat / libavcodec; ``runtime/media.cpp``), the port's own copy of
``actalker_tpu/frontend/media_native.py``. ``lib()`` is None where the
library or the libav libraries it links are absent."""
from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

RUNTIME = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "runtime")
_LIB = None


def lib():
    """The loaded library, or None (it is tried once a process)."""
    global _LIB
    if _LIB is None:
        try:
            L = ctypes.CDLL(os.path.join(RUNTIME, "libactalker_media.so"))
        except OSError:
            _LIB = False
            return None
        L.decode_audio_f32.restype = ctypes.c_int64
        L.decode_audio_f32.argtypes = [
            ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float))]
        L.actalker_free.argtypes = [ctypes.c_void_p]
        L.actalker_free.restype = None
        L.video_info.restype = ctypes.c_int
        L.video_info.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int64)]
        L.read_video_rgb.restype = ctypes.c_int64
        L.read_video_rgb.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.c_int]
        L.write_video_rgb.restype = ctypes.c_int
        L.write_video_rgb.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int,
            ctypes.c_char_p]
        _LIB = L
    return _LIB or None


def _need():
    L = lib()
    if L is None:
        raise RuntimeError("native media library not built (make -C runtime)")
    return L


def decode_audio(path: str, sample_rate: int = 16000) -> np.ndarray:
    """Any container's audio as mono float32 PCM at ``sample_rate``."""
    L = _need()
    out = ctypes.POINTER(ctypes.c_float)()
    n = L.decode_audio_f32(path.encode(), sample_rate, ctypes.byref(out))
    if n < 0:
        raise RuntimeError(f"audio decode failed ({n}): {path}")
    arr = np.ctypeslib.as_array(out, shape=(n,)).copy() if n else \
        np.zeros(0, np.float32)
    L.actalker_free(out)
    return arr


def video_info(path: str) -> Tuple[int, int, float, int]:
    """(width, height, fps, frame count or <= 0 when unknown)."""
    L = _need()
    w, h = ctypes.c_int(), ctypes.c_int()
    fps, n = ctypes.c_double(), ctypes.c_int64()
    if L.video_info(path.encode(), ctypes.byref(w), ctypes.byref(h),
                    ctypes.byref(fps), ctypes.byref(n)) != 0:
        raise RuntimeError(f"video probe failed: {path}")
    return w.value, h.value, fps.value, n.value


def read_video(path: str, limit: Optional[int] = None) -> np.ndarray:
    """(F, H, W, 3) uint8 RGB frames, at most ``limit``."""
    L = _need()
    w, h, _, nframes = video_info(path)
    cap = limit or (nframes if nframes > 0 else 1 << 16)
    stride_w = (w + 15) // 16 * 16   # the scaler writes aligned row tails
    buf = np.empty((cap, h, stride_w, 3), np.uint8)
    got = L.read_video_rgb(path.encode(),
                           buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                           cap, stride_w)
    if got < 0:
        raise RuntimeError(f"video decode failed: {path}")
    return np.ascontiguousarray(buf[:got, :, :w])


def write_video(path: str, frames: np.ndarray, fps: float = 12.5,
                crf: int = 17, audio_path: Optional[str] = None) -> None:
    """H.264 (crf ``crf``) of (F, H, W, 3) uint8 or [0, 1] float frames,
    with the audio of ``audio_path`` muxed as AAC when given."""
    L = _need()
    if frames.dtype != np.uint8:
        frames = (np.clip(frames, 0, 1) * 255).round().astype(np.uint8)
    frames = np.ascontiguousarray(frames)
    n, h, w, _ = frames.shape
    r = L.write_video_rgb(path.encode(),
                          frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                          n, w, h, float(fps), int(crf),
                          audio_path.encode() if audio_path else b"")
    if r != 0:
        raise RuntimeError(f"video encode failed ({r}): {path}")
