"""Sync-C / Sync-D evaluation end to end, twin of
``actalker_tpu/evaluation/sync_eval.py``: raw video -> per-track (offset,
confidence, distance), as the reference's driver
(``eval/evaluation.py:46-263`` + ``eval/sync/SyncNetInstance.py:42-148``):

  1. 25 fps frames + 16 kHz mono audio (``Evaluation.prepare_video``);
  2. S3FD face detection per frame (``det_for_video``, conf_th 0.9, scale
     0.25);
  3. content-difference scene cuts (PySceneDetect ``ContentDetector``);
  4. greedy IoU face tracking with gap tolerance and box interpolation
     (``track_shot``);
  5. 224 x 224 face tubes with median-filtered, padded box smoothing
     (``crop_video``);
  6. 13 x 20 MFCC windows (python_speech_features' ``mfcc`` defaults) and
     5-frame lip stacks through the SyncNet towers;
  7. zero-padded +-vshift pairwise distances (``calc_pdist``): offset =
     vshift - argmin of the mean distance, Sync-C = median - min, Sync-D =
     min.

The towers and the detector's network run on their device
(``evaluation/syncnet.py``, ``evaluation/s3fd.py``); the rest is host
numpy, copied from the JAX twin. ``evaluate_sync`` reads clips through a
clip reader (``evaluation/run_eval.py``: video files, or ``.npy`` frame
stacks with a WAV beside them on a machine without a video decoder).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from actalker_tpu_torch.models.scrfd import cv_bilinear_resize


# --------------------------------------------------------------------------
# 1. MFCC — python_speech_features.mfcc() defaults, numpy-exact
# --------------------------------------------------------------------------

def _hz2mel(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz, np.float64) / 700.0)


def _mel2hz(mel):
    return 700.0 * (10.0 ** (np.asarray(mel, np.float64) / 2595.0) - 1.0)


def _mel_banks(nfilt=26, nfft=512, sr=16000, lowfreq=0, highfreq=None):
    highfreq = highfreq or sr // 2
    melpts = np.linspace(_hz2mel(lowfreq), _hz2mel(highfreq), nfilt + 2)
    bins = np.floor((nfft + 1) * _mel2hz(melpts) / sr).astype(int)
    fbank = np.zeros((nfilt, nfft // 2 + 1))
    for j in range(nfilt):
        for i in range(bins[j], bins[j + 1]):
            fbank[j, i] = (i - bins[j]) / (bins[j + 1] - bins[j])
        for i in range(bins[j + 1], bins[j + 2]):
            fbank[j, i] = (bins[j + 2] - i) / (bins[j + 2] - bins[j + 1])
    return fbank


def _dct2_ortho(x):
    n = x.shape[1]
    k = np.arange(n)
    basis = np.cos(np.pi * (2 * k[None, :, None] + 1) * k[None, None, :]
                   / (2 * n))  # (1, n_in, n_out)
    y = (x[:, :, None] * basis).sum(axis=1) * 2
    y[:, 0] *= np.sqrt(1.0 / (4 * n))
    y[:, 1:] *= np.sqrt(1.0 / (2 * n))
    return y


def mfcc(signal: np.ndarray, samplerate: int = 16000, winlen: float = 0.025,
         winstep: float = 0.01, numcep: int = 13, nfilt: int = 26,
         nfft: int = 512, preemph: float = 0.97, ceplifter: int = 22,
         append_energy: bool = True) -> np.ndarray:
    """python_speech_features.mfcc with default arguments (the exact frontend
    of ``SyncNetInstance.evaluate``, SyncNetInstance.py:84-88). ``signal`` is
    the raw int16-scale waveform (scipy wavfile convention)."""
    signal = np.asarray(signal, np.float64)
    sig = np.append(signal[0], signal[1:] - preemph * signal[:-1])
    frame_len = int(round(winlen * samplerate))
    frame_step = int(round(winstep * samplerate))
    slen = len(sig)
    if slen <= frame_len:
        numframes = 1
    else:
        numframes = 1 + int(math.ceil((slen - frame_len) / frame_step))
    padlen = (numframes - 1) * frame_step + frame_len
    sig = np.concatenate([sig, np.zeros(padlen - slen)])
    idx = (np.tile(np.arange(frame_len), (numframes, 1))
           + np.tile(np.arange(0, numframes * frame_step, frame_step),
                     (frame_len, 1)).T)
    frames = sig[idx]
    pspec = (np.abs(np.fft.rfft(frames, nfft)) ** 2) / nfft
    energy = pspec.sum(axis=1)
    energy = np.where(energy == 0, np.finfo(np.float64).eps, energy)
    feat = pspec @ _mel_banks(nfilt, nfft, samplerate).T
    feat = np.where(feat == 0, np.finfo(np.float64).eps, feat)
    feat = np.log(feat)
    feat = _dct2_ortho(feat)[:, :numcep]
    n = np.arange(numcep)
    feat = feat * (1 + (ceplifter / 2.0) * np.sin(np.pi * n / ceplifter))
    if append_energy:
        feat[:, 0] = np.log(energy)
    return feat  # (frames, numcep)


# --------------------------------------------------------------------------
# 2. Scene detection — PySceneDetect ContentDetector semantics
# --------------------------------------------------------------------------

def _rgb_to_hsv_cv(frames: np.ndarray) -> np.ndarray:
    """cv2-style HSV (H in [0,180)) for uint8 RGB frames, vectorized."""
    f = frames.astype(np.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    v = np.max(f, axis=-1)
    c = v - np.min(f, axis=-1)
    s = np.where(v > 0, 255.0 * c / np.maximum(v, 1e-9), 0.0)
    cs = np.maximum(c, 1e-9)
    h = np.where(v == r, 60.0 * (g - b) / cs,
                 np.where(v == g, 120.0 + 60.0 * (b - r) / cs,
                          240.0 + 60.0 * (r - g) / cs))
    h = np.where(c == 0, 0.0, h)
    h = np.where(h < 0, h + 360.0, h) / 2.0
    return np.stack([h, s, v], axis=-1)


def scene_detect(frames: np.ndarray, threshold: float = 27.0,
                 min_scene_len: int = 15,
                 downscale: Optional[int] = None) -> List[Tuple[int, int]]:
    """Content-diff scene cuts over RGB uint8 frames (T, H, W, 3).

    PySceneDetect ``ContentDetector`` math (``eval/evaluation.py:248-263``
    uses its defaults): per consecutive pair, mean absolute difference of the
    H, S, V planes averaged over the three planes; a cut fires where the
    score exceeds ``threshold`` and the scene is at least ``min_scene_len``
    frames. Returns [start, end) frame ranges covering the clip."""
    t = len(frames)
    if t == 0:
        return []
    if downscale is None:
        downscale = max(1, frames.shape[2] // 200)
    small = frames[:, ::downscale, ::downscale]
    hsv = _rgb_to_hsv_cv(small)
    delta = np.abs(np.diff(hsv, axis=0)).mean(axis=(1, 2))  # (T-1, 3)
    score = delta.mean(axis=1)
    cuts = []
    last = 0
    for i in range(1, t):
        if score[i - 1] >= threshold and (i - last) >= min_scene_len:
            cuts.append(i)
            last = i
    bounds = [0] + cuts + [t]
    return list(zip(bounds[:-1], bounds[1:]))


# --------------------------------------------------------------------------
# 3. IOU face tracking (eval/evaluation.py:46-83)
# --------------------------------------------------------------------------

def _iou(a, b):
    xa, ya = max(a[0], b[0]), max(a[1], b[1])
    xb, yb = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0, xb - xa) * max(0, yb - ya)
    area_a = (a[2] - a[0]) * (a[3] - a[1])
    area_b = (b[2] - b[0]) * (b[3] - b[1])
    return inter / float(area_a + area_b - inter)


def track_shot(scenefaces: List[List[dict]], num_failed_det: int = 25,
               min_track: int = 100, min_face_size: int = 100,
               iou_thres: float = 0.5) -> List[dict]:
    """Greedy IOU tracker with linear box interpolation over gaps — exact
    ``track_shot`` semantics incl. its quirks (faces are consumed from the
    per-frame lists; a track ends when the frame gap exceeds
    ``num_failed_det``). ``scenefaces[i]`` = list of {'frame', 'bbox'}."""
    scenefaces = [list(ff) for ff in scenefaces]
    tracks = []
    while True:
        track = []
        for framefaces in scenefaces:
            for face in framefaces:
                if not track:
                    track.append(face)
                    framefaces.remove(face)
                elif face["frame"] - track[-1]["frame"] <= num_failed_det:
                    if _iou(face["bbox"], track[-1]["bbox"]) > iou_thres:
                        track.append(face)
                        framefaces.remove(face)
                        continue
                else:
                    break
        if not track:
            break
        if len(track) > min_track:
            framenum = np.array([f["frame"] for f in track])
            bboxes = np.array([np.asarray(f["bbox"]) for f in track])
            frame_i = np.arange(framenum[0], framenum[-1] + 1)
            bboxes_i = np.stack(
                [np.interp(frame_i, framenum, bboxes[:, ij])
                 for ij in range(4)], axis=1)
            if max(np.mean(bboxes_i[:, 2] - bboxes_i[:, 0]),
                   np.mean(bboxes_i[:, 3] - bboxes_i[:, 1])) > min_face_size:
                tracks.append({"frame": frame_i, "bbox": bboxes_i})
    return tracks


# --------------------------------------------------------------------------
# 4. 224x224 face tube crop (eval/evaluation.py:86-136)
# --------------------------------------------------------------------------

def _medfilt(x: np.ndarray, k: int = 13) -> np.ndarray:
    """scipy.signal.medfilt semantics (zero-padded median)."""
    pad = k // 2
    xp = np.concatenate([np.zeros(pad), np.asarray(x, np.float64),
                         np.zeros(pad)])
    return np.stack([np.median(xp[i:i + k]) for i in range(len(x))])


def crop_face_tube(frames: np.ndarray, track: dict,
                   crop_scale: float = 0.40) -> np.ndarray:
    """(T_track, 224, 224, 3) face tube from full frames, reference
    ``crop_video`` smoothing/padding semantics (pad value 110)."""
    dets_s, dets_x, dets_y = [], [], []
    for det in track["bbox"]:
        dets_s.append(max(det[3] - det[1], det[2] - det[0]) / 2)
        dets_y.append((det[1] + det[3]) / 2)
        dets_x.append((det[0] + det[2]) / 2)
    s = _medfilt(dets_s, 13)
    x = _medfilt(dets_x, 13)
    y = _medfilt(dets_y, 13)
    out = []
    for fidx, frame_no in enumerate(track["frame"]):
        cs = crop_scale
        bs = s[fidx]
        bsi = int(bs * (1 + 2 * cs))
        image = frames[int(frame_no)]
        padded = np.pad(image, ((bsi, bsi), (bsi, bsi), (0, 0)),
                        "constant", constant_values=110)
        my = y[fidx] + bsi
        mx = x[fidx] + bsi
        face = padded[int(my - bs):int(my + bs * (1 + 2 * cs)),
                      int(mx - bs * (1 + cs)):int(mx + bs * (1 + cs))]
        out.append(cv_bilinear_resize(face, 224, 224))
    return np.stack(out)


# --------------------------------------------------------------------------
# 5. SyncNet scoring (eval/sync/SyncNetInstance.py:19-148)
# --------------------------------------------------------------------------

def calc_pdist(feat1: np.ndarray, feat2: np.ndarray,
               vshift: int = 15) -> np.ndarray:
    """(T, win_size) pairwise L2 distances with ZERO-padded audio shifts —
    the reference pads feat2 and includes boundary distances against zero
    rows (SyncNetInstance.py:19-30), unlike plain truncation."""
    win = 2 * vshift + 1
    feat2p = np.concatenate(
        [np.zeros((vshift, feat2.shape[1])), feat2,
         np.zeros((vshift, feat2.shape[1]))], axis=0)
    dists = np.empty((len(feat1), win))
    for i in range(len(feat1)):
        d = feat2p[i:i + win] - feat1[i][None]
        dists[i] = np.sqrt((d * d).sum(axis=1) + 1e-12)
    return dists


def score_tube(lip_emb: np.ndarray, aud_emb: np.ndarray,
               vshift: int = 15) -> Tuple[int, float, float]:
    """(offset, Sync-C, Sync-D) from per-window tower embeddings —
    ``SyncNetInstance.evaluate`` tail (SyncNetInstance.py:126-148)."""
    dists = calc_pdist(lip_emb, aud_emb, vshift)
    mdist = dists.mean(axis=0)
    minidx = int(np.argmin(mdist))
    minval = float(mdist[minidx])
    offset = vshift - minidx
    conf = float(np.median(mdist) - minval)
    return offset, conf, minval


@dataclasses.dataclass
class SyncEvaluator:
    """Video -> sync scores with the port's SyncNet and S3FD as the model
    stages (``syncnet`` / ``s3fd`` may be None where a test gives the
    detections or embeddings itself)."""

    syncnet: Optional[torch.nn.Module] = None   # evaluation.syncnet.SyncNet
    s3fd: Optional[object] = None               # evaluation.s3fd.S3FD
    facedet_scale: float = 0.25
    crop_scale: float = 0.40
    min_track: int = 100
    num_failed_det: int = 25
    min_face_size: int = 100
    vshift: int = 15
    batch_size: int = 20

    # -- model stages -----------------------------------------------------
    @torch.no_grad()
    def _embed(self, lips: np.ndarray, mfccs: np.ndarray):
        """(N, 5, 224, 224, 3) BGR stacks and (N, 13, 20) MFCC windows ->
        the towers' (N, 1024) embeddings."""
        dev = next(self.syncnet.parameters()).device
        lip_out, aud_out = [], []
        for i in range(0, len(lips), self.batch_size):
            lip = torch.from_numpy(lips[i:i + self.batch_size]).to(dev)
            aud = torch.from_numpy(mfccs[i:i + self.batch_size]).to(dev)
            lip_out.append(self.syncnet.forward_lip(
                lip.permute(0, 4, 1, 2, 3)).cpu().numpy())
            aud_out.append(self.syncnet.forward_aud(aud[:, None]).cpu().numpy())
        return np.concatenate(lip_out), np.concatenate(aud_out)

    def detect_faces(self, frames_rgb: np.ndarray) -> List[List[dict]]:
        """S3FD per frame (``det_for_video``: conf_th 0.9, scale
        ``facedet_scale``), fed BGR."""
        dets = []
        for fidx, frame in enumerate(frames_rgb):
            bboxes = self.s3fd.detect_faces(
                np.ascontiguousarray(frame[..., ::-1]), conf_th=0.9,
                scales=[self.facedet_scale])
            dets.append([{"frame": fidx, "bbox": list(map(float, b[:-1])),
                          "conf": float(b[-1])} for b in bboxes])
        return dets

    # -- full pipeline ----------------------------------------------------
    def evaluate_tube(self, tube_rgb: np.ndarray, audio_16k: np.ndarray
                      ) -> Tuple[int, float, float]:
        """(T, 224, 224, 3) RGB tube + int16-scale 16 kHz waveform ->
        scores. Windows as ``SyncNetInstance.evaluate``: lip stacks of 5
        consecutive frames (BGR into the tower), MFCC 13 x 20 slices at 4
        MFCC frames a video frame. A tube shorter than one window raises
        ``ValueError``."""
        feats = mfcc(audio_16k).T  # (13, frames)
        min_len = min(len(tube_rgb), feats.shape[1] // 4,
                      int(len(audio_16k) // 640))
        lastframe = min_len - 5
        if lastframe <= 0:
            raise ValueError("tube too short for a 5-frame window")
        lips = np.stack([tube_rgb[i:i + 5, :, :, ::-1].astype(np.float32)
                         for i in range(lastframe)])       # (N, 5, 224, 224, 3)
        auds = np.stack([feats[:, i * 4:i * 4 + 20].astype(np.float32)
                         for i in range(lastframe)])       # (N, 13, 20)
        lip_emb, aud_emb = self._embed(lips, auds)
        return score_tube(lip_emb, aud_emb, self.vshift)

    def evaluate_video(self, frames_rgb: np.ndarray, audio_16k: np.ndarray,
                       fps: float = 25.0) -> List[Tuple[int, float, float]]:
        """Detect -> scene cuts -> tracks -> tubes -> scores; one (offset,
        conf, dist) per face track."""
        faces = self.detect_faces(frames_rgb)
        tracks = []
        for (s0, s1) in scene_detect(frames_rgb):
            if s1 - s0 >= self.min_track:
                tracks.extend(track_shot(faces[s0:s1], self.num_failed_det,
                                         self.min_track, self.min_face_size))
        results = []
        for track in tracks:
            tube = crop_face_tube(frames_rgb, track, self.crop_scale)
            f0, f1 = int(track["frame"][0]), int(track["frame"][-1]) + 1
            a0, a1 = int(f0 / fps * 16000), int(f1 / fps * 16000)
            results.append(self.evaluate_tube(tube, audio_16k[a0:a1]))
        return results


def resample_to_25fps(frames: np.ndarray, fps: float) -> np.ndarray:
    """Frames at ``fps`` -> 25 fps by index (the reference re-encodes with
    ``ffmpeg -r 25``)."""
    if abs(fps - 25.0) > 1e-3 and fps > 0:
        idx = np.round(np.arange(0, len(frames) * 25.0 / fps) * fps / 25.0)
        frames = frames[np.clip(idx.astype(int), 0, len(frames) - 1)]
    return frames


def evaluate_sync(video_path: str, syncnet, s3fd, reader, audio_reader,
                  max_frames: Optional[int] = None,
                  **kwargs) -> List[Tuple[int, float, float]]:
    """A clip's path -> per-track (offset, Sync-C, Sync-D). ``reader`` gives
    its frames and fps (``run_eval.VideoClipReader`` / ``NpyClipReader``),
    ``audio_reader`` its 16 kHz audio; frames go to 25 fps by index and the
    audio to int16 scale, cut to the frames' length. ``max_frames`` bounds
    the frames read (at the source fps)."""
    frames = resample_to_25fps(reader.frames(video_path, max_frames),
                               reader.fps(video_path))
    audio = audio_reader(video_path)
    if audio.dtype.kind == "f":
        audio = np.clip(audio * 32768.0, -32768, 32767)
    audio = audio[:max(1, int(len(frames) * 16000 / 25))]
    ev = SyncEvaluator(syncnet=syncnet, s3fd=s3fd, **kwargs)
    return ev.evaluate_video(frames, audio, fps=25.0)
