"""Whisper log-mel features on the host, the port's own copy of
``actalker_tpu/frontend/audio.py`` (the reference's ``get_audio_feature``,
``src/dataset/test_preprocess.py:121-137``: a 16 kHz load, then HF's
``WhisperFeatureExtractor`` over 30 s windows concatenated on the time
axis; the video frame count is ``len(audio) // 640``).

``log_mel_spectrogram`` runs the native ``runtime/libactalker_mel.so`` when
it loads, else numpy: hann STFT (n_fft 400, hop 160), slaney mel filterbank
(80 bins, 0-8 kHz), log10 with Whisper's dynamic-range compression.
``load_audio`` decodes through the native libav runtime, then the ``ffmpeg``
binary, then (WAV only) scipy.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from typing import Tuple

import numpy as np

from actalker_tpu_torch.frontend import media_native

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160
N_MELS = 80
CHUNK_SAMPLES = 480000  # 30 s, the reference's 750 * 640 window


def load_audio(path: str, sr: int = SAMPLE_RATE) -> np.ndarray:
    """Decode to mono float32 PCM at ``sr``."""
    if media_native.lib() is not None:
        return media_native.decode_audio(path, sr)
    if shutil.which("ffmpeg"):
        cmd = ["ffmpeg", "-nostdin", "-i", path, "-f", "f32le", "-ac", "1",
               "-ar", str(sr), "-"]
        out = subprocess.run(cmd, capture_output=True, check=True).stdout
        return np.frombuffer(out, np.float32).copy()
    if path.endswith(".wav"):
        from scipy.io import wavfile

        rate, data = wavfile.read(path)
        data = data.astype(np.float32)
        if data.ndim > 1:
            data = data.mean(axis=1)
        if data.max() > 2.0:
            data = data / 32768.0
        if rate != sr:
            n = int(len(data) * sr / rate)
            data = np.interp(np.linspace(0, len(data) - 1, n),
                             np.arange(len(data)), data).astype(np.float32)
        return data
    raise RuntimeError(
        "no audio decoder: build runtime/libactalker_media.so (make -C runtime)")


def _hz_to_mel(f):
    # slaney scale
    f = np.asarray(f, np.float64)
    mel = 3.0 * f / 200.0
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0)
                    / (np.log(6.4) / 27.0), mel)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    f = 200.0 * m / 3.0
    return np.where(m >= 15.0, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), f)


def mel_filterbank(sr=SAMPLE_RATE, n_fft=N_FFT, n_mels=N_MELS) -> np.ndarray:
    """(n_mels, n_fft // 2 + 1) slaney-normalized triangular filterbank."""
    fmax = sr / 2
    freqs = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(fmax), n_mels + 2))
    fft_freqs = np.linspace(0, fmax, n_fft // 2 + 1)
    fb = np.zeros((n_mels, n_fft // 2 + 1))
    for i in range(n_mels):
        lower = (fft_freqs - freqs[i]) / (freqs[i + 1] - freqs[i])
        upper = (freqs[i + 2] - fft_freqs) / (freqs[i + 2] - freqs[i + 1])
        fb[i] = np.maximum(0.0, np.minimum(lower, upper))
    fb *= (2.0 / (freqs[2:] - freqs[:-2]))[:, None]
    return fb.astype(np.float32)


_FILTERS = None
_NATIVE = None


def native_lib():
    """ctypes handle of ``runtime/libactalker_mel.so``, or None."""
    global _NATIVE
    if _NATIVE is None:
        try:
            L = ctypes.CDLL(os.path.join(media_native.RUNTIME,
                                         "libactalker_mel.so"))
            L.whisper_log_mel.restype = ctypes.c_int32
            L.whisper_log_mel.argtypes = [ctypes.POINTER(ctypes.c_float),
                                          ctypes.c_int64,
                                          ctypes.POINTER(ctypes.c_float)]
            _NATIVE = L
        except OSError:
            _NATIVE = False
    return _NATIVE or None


def _log_mel_native(seg: np.ndarray) -> np.ndarray:
    seg = np.ascontiguousarray(seg, np.float32)
    frames = len(seg) // HOP
    out = np.empty((N_MELS, frames), np.float32)
    got = native_lib().whisper_log_mel(
        seg.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(seg),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if got != frames:
        raise RuntimeError(f"native log-mel gave {got} frames, expected {frames}")
    return out


def _log_mel_numpy(seg: np.ndarray) -> np.ndarray:
    global _FILTERS
    if _FILTERS is None:
        _FILTERS = mel_filterbank()
    window = np.hanning(N_FFT + 1)[:-1].astype(np.float32)
    frames = 1 + len(seg) // HOP
    seg_p = np.pad(seg, (N_FFT // 2, N_FFT // 2), mode="reflect")
    idx = np.arange(N_FFT)[None, :] + HOP * np.arange(frames)[:, None]
    spec = np.fft.rfft(seg_p[idx] * window[None], axis=-1)
    power = (spec.real ** 2 + spec.imag ** 2)[:-1]   # whisper drops the last
    logm = np.log10(np.maximum(power.astype(np.float32) @ _FILTERS.T, 1e-10))
    logm = np.maximum(logm, logm.max() - 8.0)
    return ((logm + 4.0) / 4.0).T                    # (80, frames)


def log_mel_spectrogram(audio: np.ndarray, pad_to_chunk: bool = True,
                        use_native: bool = True) -> np.ndarray:
    """(T samples,) -> (80, frames) Whisper log-mel (fp32). With
    ``pad_to_chunk`` each 30 s window is zero-padded to 3000 frames, as
    HF's feature extractor does."""
    chunks = []
    for start in range(0, max(len(audio), 1), CHUNK_SAMPLES):
        seg = audio[start:start + CHUNK_SAMPLES]
        if pad_to_chunk:
            seg = np.pad(seg, (0, CHUNK_SAMPLES - len(seg)))
        if use_native and native_lib() is not None:
            chunks.append(_log_mel_native(seg))
        else:
            chunks.append(_log_mel_numpy(seg))
    return np.concatenate(chunks, axis=1)


def whisper_features(audio_path: str) -> Tuple[np.ndarray, int]:
    """(mel (80, T), number of video frames = samples // 640)."""
    audio = load_audio(audio_path)
    return log_mel_spectrogram(audio), len(audio) // 640
