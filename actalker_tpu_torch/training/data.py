"""Training data pipeline (ParentDataset semantics, host-side numpy), the
port's own copy of ``actalker_tpu/training/data.py``; one seed gives the
same samples in both packages (the draws from ``self.rng`` come in the same
order). The samples hold numpy arrays and Python scalars only, so the
loader's worker processes never touch a CUDA device.

Parity target: ``src/dataset/portrait_audio_dataset_arcface_vasa.py`` —
JSON-metadata video-clip dataset. The exact reference ``__getitem__`` policy
(670-845) is reproduced:

* deterministic stride: 1 if the valid clip is shorter than 2T else 2
  (703-712); clip start uniform over ``[s, e - T*step]``; reference frame
  uniform over ``[drive[0]-T, drive[-1]+T]`` clamped to ``[s, e-1]``;
* union face box over the WHOLE valid clip + union mouth-landmark boxes
  (``get_union_bbox``/``get_mouth_boxes``, 586-667) -> face/mouth/exp box
  masks (``get_face_mask`` 592-598);
* augmentation: ``process_bbox`` with ``scale = 2*rand()``, random aspect
  from {1:1, 9:16, 16:9}, ``image_size = 512 + (max-512)*rand()``, LANCZOS
  crop-resize to 64-multiples (740-760, ``crop_resize_img`` 589-597);
* motion buckets: landmark-derived head/exp buckets
  (``get_head_exp_motion_bucketid`` 420-446), 5-pt outlier gate
  (``check_lmk`` 448-456, resample when > 128), and the optical-flow bucket
  on quarter-size frames (781-786, resample when > 128);
* color jitter on the VASA face crop only: random channel-range multiply +
  median-blur-or-sharpen (``_color_transfer``/``_blur_and_sharp`` 547-569);
* VASA crops: 174-landmark bbox center crop at 256 (``crop_face_vasa``
  600-617) and scale-1.7 face-box center crop (``center_crop`` 313-331);
* ArcFace head crop of the reference frame (``get_head_preprocessed_img``
  458-471); per-clip 30 s audio windowing (``get_audio_file`` 632-654);
* retry-on-exception resamples a random index (841-845).

This implementation is clean-room: it consumes per-clip metadata dicts and
injected media readers (so tests can fake IO), produces numpy sample dicts
ready for ``training/batch_builder.py``.

Known reference quirk NOT reproduced: the reference's ``get_mouth_boxes``
computes ``min(mouth_lmks[:][0])`` — i.e. min/max over the x,y coordinates of
the FIRST mouth landmark only, a degenerate point-box (656-667). We implement
the evident intent (per-axis min/max over all mouth landmarks); the quirk is
an upstream bug whose output the subsequent union/mask stage degrades into a
near-empty mouth mask.

The media readers (``VideoFrameReader``, ``NpyFrameReader``,
``AudioWindowReader``) are module-level classes, so a dataset pickles into
the loader's worker processes under any start method.
"""
from __future__ import annotations

import dataclasses
import json
import random
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from actalker_tpu_torch.frontend.preprocess import (
    get_bbox_by_aspect,
    process_bbox,
    resize_image,
)


@dataclasses.dataclass
class DataConfig:
    n_sample_frames: int = 25
    image_size: int = 512          # reference cfg['image_size'] (upper end)
    vasa_image_size: int = 256
    motion_bucket_max: int = 128
    color_jitter: bool = True
    retry: int = 8
    # Pin aspect to 1:1 and the resize target to exactly image_size so every
    # sample lands on the same (image_size//64*64)^2 shape — required when
    # batch_size > 1 stacks samples (the reference trains bs=1/GPU and keeps
    # the random-size augmentation; with this False we match it exactly).
    deterministic_shape: bool = False


def load_metadata(json_paths: Sequence[str]) -> List[Dict[str, Any]]:
    """Each JSON holds a list of clip records:
    {video_path, audio_path?, frames, bboxes [[x1,y1,x2,y2]...],
     landmarks?, valid_clip?, quality?, similarity?}.

    ``quality``/``similarity`` are carried for curation tooling but do NOT
    gate sampling — the reference loads its score lists without ever using
    them (``portrait_audio_dataset_arcface_vasa.py:689-700``); the live
    resample gates are the landmark-outlier and optical-flow ones."""
    clips = []
    for p in json_paths:
        with open(p) as f:
            data = json.load(f)
        clips.extend(data if isinstance(data, list) else data.get("clips", []))
    return clips


# --------------------------------------------------------------------------
# Sampling policy (pure functions so the decisions are fixture-testable)
# --------------------------------------------------------------------------

def clip_stride(valid_len: int, t: int) -> int:
    """Reference 703-707: stride 1 when the valid clip is shorter than 2T,
    else stride 2 (never random)."""
    return 1 if valid_len < 2 * t else 2


def sample_clip_indices(rng: random.Random, s: int, e: int, t: int
                        ) -> Tuple[List[int], int, int]:
    """(drive_idx_list, src_idx, step) with the exact reference bounds
    (703-717): start ~ U[s, e - T*step] inclusive; src ~ U[drive[0]-T,
    drive[-1]+T] clamped to [s, e-1]."""
    if e - s < t:
        raise ValueError(f"valid clip too short ({e - s} < {t})")
    step = clip_stride(e - s, t)
    start = rng.randint(s, e - t * step)
    drive = list(range(start, start + t * step, step))
    src = rng.randint(drive[0] - t, drive[-1] + t)
    src = max(min(src, e - 1), s)
    return drive, src, step


def union_bbox(bboxes: np.ndarray) -> np.ndarray:
    """Per-axis min/max union (``get_union_bbox`` 570-576)."""
    b = np.asarray(bboxes, np.float64)
    return np.array([b[:, 0].min(), b[:, 1].min(),
                     b[:, 2].max(), b[:, 3].max()])


def mouth_union_box(landmarks: Sequence[np.ndarray]) -> np.ndarray:
    """Union of per-frame mouth-landmark boxes. 256-pt layout: mouth =
    points 102:136 (``get_mouth_boxes`` 656-667 — see module docstring for
    the upstream quirk we fix); 68-pt layout: points 48:68."""
    boxes = []
    for lmk in landmarks:
        lmk = np.asarray(lmk, np.float64)
        m = lmk[102:136] if len(lmk) >= 136 else lmk[48:68]
        boxes.append([m[:, 0].min(), m[:, 1].min(),
                      m[:, 0].max(), m[:, 1].max()])
    return union_bbox(np.asarray(boxes))


def box_mask(height: int, width: int, bbox: Sequence[float]) -> np.ndarray:
    """``get_face_mask`` 592-598: zeros with a 255-filled rounded box,
    min corner clamped at 0; returned as float 0/1 (H, W)."""
    x1, y1, x2, y2 = bbox
    mask = np.zeros((height, width), np.float32)
    mask[round(max(y1, 0)):round(y2), round(max(x1, 0)):round(x2)] = 1.0
    return mask


def crop_resize_img(img: np.ndarray, bbox: Sequence[float],
                    image_size: float,
                    out_hw: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """``crop_resize_img`` 589-597: PIL-style crop to the (possibly
    out-of-range) box, then scale so area ~= image_size^2, both dims floored
    to 64-multiples, LANCZOS.

    ``out_hw`` pins the output shape exactly (the deterministic-shape path:
    the reference's ``int(w*scale)//64*64`` float math lands on 448 instead
    of 512 for ~14% of square crop sizes, which would make batched
    ``np.stack`` ragged)."""
    x1, y1, x2, y2 = [int(round(v)) for v in bbox]
    h, w = img.shape[:2]
    # PIL .crop pads out-of-range regions with zeros
    out = np.zeros((y2 - y1, x2 - x1) + img.shape[2:], img.dtype)
    sy1, sy2 = max(y1, 0), min(y2, h)
    sx1, sx2 = max(x1, 0), min(x2, w)
    if sy2 > sy1 and sx2 > sx1:
        out[sy1 - y1:sy2 - y1, sx1 - x1:sx2 - x1] = img[sy1:sy2, sx1:sx2]
    if out_hw is not None:
        return resize_image(out, out_hw)
    ch, cw = out.shape[:2]
    scale = np.sqrt(image_size ** 2 / (ch * cw))
    new_w = int(cw * scale) // 64 * 64
    new_h = int(ch * scale) // 64 * 64
    return resize_image(out, (max(new_h, 64), max(new_w, 64)))


def center_crop(img: np.ndarray, face_bbox: Sequence[float],
                scale: float = 1.0) -> np.ndarray:
    """``center_crop`` 313-331: square crop of half-size
    ``max(w, h)//2 * scale`` around the box center, zero-padded at edges."""
    h, w = img.shape[:2]
    x0, y0, x1, y1 = face_bbox[:4]
    cx, cy = int((x0 + x1) / 2), int((y0 + y1) / 2)
    c = int(int(max(x1 - x0, y1 - y0)) // 2 * scale)
    nx0, ny0, nx1, ny1 = cx - c, cy - c, cx + c, cy + c
    pl = max(-nx0, 0); pt = max(-ny0, 0)
    pr = max(nx1 - w, 0); pb = max(ny1 - h, 0)
    crop = img[max(ny0, 0):min(ny1, h), max(nx0, 0):min(nx1, w)]
    return np.pad(crop, ((pt, pb), (pl, pr)) + ((0, 0),) * (img.ndim - 2))


def get_pts5(pts: np.ndarray) -> np.ndarray:
    """5-pt reduction of a landmark set (``face_align/utils.py:153-172``)."""
    pts = np.asarray(pts, np.float32)
    if len(pts) == 5:
        return pts
    if len(pts) in (90, 94):
        return np.stack([pts[16] * 0.5 + pts[20] * 0.5,
                         pts[24] * 0.5 + pts[28] * 0.5,
                         pts[32], pts[45], pts[51]])
    if len(pts) == 256:
        return np.stack([pts[32] * 0.5 + pts[44] * 0.5,
                         pts[56] * 0.5 + pts[68] * 0.5,
                         pts[80], pts[102], pts[120]])
    raise ValueError(f"invalid pts ({len(pts)})")


def get_head_exp_motion_bucketid(lmks: Sequence[np.ndarray],
                                 max_value: int = 128) -> Tuple[int, int]:
    """(head_bucket, exp_bucket) — exact ``get_head_exp_motion_bucketid``
    math (420-446): expression landmarks are points :102 relative to point 80
    (nose anchor); scale = first-frame landmark extent; exp variance *1024,
    head (point 80) variance *256, both clamped to [0, max_value]."""
    exp_lmks = np.array([np.asarray(l, np.float64)[:102]
                         - np.asarray(l, np.float64)[80] for l in lmks])
    init = exp_lmks[0]
    scale = np.sqrt(((init.max(0) - init.min(0)) ** 2).sum())
    exp_var = np.sqrt(((exp_lmks - exp_lmks.mean(0)) ** 2).sum(2)).mean()
    exp_var = int(exp_var / scale * 1024)
    head = np.array([np.asarray(l, np.float64)[80] for l in lmks])
    head_var = np.sqrt(((head - head.mean(0)) ** 2).sum(1)).mean()
    head_var = int(head_var / scale * 256)
    clamp = lambda v: max(0, min(v, max_value))  # noqa: E731
    return clamp(head_var), clamp(exp_var)


def check_lmk(lmks: Sequence[np.ndarray]) -> int:
    """Outlier score (``check_lmk`` 448-456): per-frame mean 5-pt landmark
    velocity normalized by the first-frame extent; round(max/mean * 32).
    The caller resamples when this exceeds 128 (i.e. a single-frame jump
    4x the average — a landmark-tracking glitch)."""
    p5 = np.array([get_pts5(l) for l in lmks], np.float64)
    init = p5[0]
    scale = np.sqrt(((init.max(0) - init.min(0)) ** 2).sum())
    v = np.sqrt(((p5[1:] - p5[:-1]) ** 2).sum(2)).mean(1) / scale
    return round(float(v.max() / v.mean()) * 32)


def motion_bucket_from_landmarks(landmarks: np.ndarray, max_value: int = 128
                                 ) -> int:
    """Landmark-displacement motion bucket (``get_motion_bucketid`` family):
    mean per-frame landmark displacement, scaled; clips above max_value are
    resampled by the caller. (Generic fallback when the 256-pt layout needed
    by ``get_head_exp_motion_bucketid`` is unavailable.)"""
    if len(landmarks) < 2:
        return 0
    d = np.linalg.norm(np.diff(landmarks.astype(np.float64), axis=0), axis=-1)
    return int(min(d.mean() * 8.0, max_value))


def motion_bucket_from_flow(frames: np.ndarray, max_value: int = 255) -> int:
    """Farneback optical-flow motion bucket
    (``motion_estimation_service.py:113-129``): per-pair mean flow magnitude
    * 0.1, maxed over pairs, mapped to 0..255 and clamped to ``max_value``."""
    from actalker_tpu_torch.frontend.optical_flow import get_motion_score

    if len(frames) < 2:
        return 0
    return min(get_motion_score(frames), max_value)


# --------------------------------------------------------------------------
# Augmentation (reference _color_transfer / _blur_and_sharp, 547-569)
# --------------------------------------------------------------------------

def color_transfer(rng: random.Random, img: np.ndarray) -> np.ndarray:
    """Random per-channel-range gain in [0.3, 1.6] over a random contiguous
    channel slice, clamped to [0, 255] (``_color_transfer`` 547-555)."""
    c = rng.uniform(0.3, 1.6)
    start = rng.randrange(0, 2)
    end = rng.randrange(start + 1, 4)
    out = img.astype(np.float32).copy()
    out[..., start:end] = np.clip(out[..., start:end] * c, 0, 255)
    return out.astype(img.dtype)


def _median_blur(img: np.ndarray, ksize: int) -> np.ndarray:
    """cv2.medianBlur equivalent (edge-replicated median)."""
    pad = ksize // 2
    p = np.pad(img, ((pad, pad), (pad, pad), (0, 0)), mode="edge")
    win = np.lib.stride_tricks.sliding_window_view(
        p, (ksize, ksize), axis=(0, 1))
    return np.median(win, axis=(-2, -1)).astype(img.dtype)


def _sharpen(img: np.ndarray) -> np.ndarray:
    """cv2.filter2D with the reference 3x3 kernel [[-1,-1,-1],[-1,9,-1],
    [-1,-1,-1]] (edge-replicated), saturating uint8."""
    f = img.astype(np.float32)
    p = np.pad(f, ((1, 1), (1, 1), (0, 0)), mode="edge")
    out = 9 * f
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            out -= p[1 + dy:1 + dy + f.shape[0], 1 + dx:1 + dx + f.shape[1]]
    return np.clip(out, 0, 255).astype(img.dtype)


def blur_and_sharp(rng: random.Random, img: np.ndarray) -> np.ndarray:
    """50/50 median blur (ksize in {3,5,7,9}) or 3x3 sharpen
    (``_blur_and_sharp`` 556-565)."""
    if rng.randrange(0, 2):
        ksize = rng.choice([3, 5, 7, 9])
        return _median_blur(img, ksize)
    return _sharpen(img)


def augmentation_mtn(rng: random.Random, img: np.ndarray) -> np.ndarray:
    """``augmentation_mtn_pcavs`` 566-569: color transfer then blur/sharpen
    (applied only to the VASA motion face crop)."""
    return blur_and_sharp(rng, color_transfer(rng, img))


# --------------------------------------------------------------------------
# Dataset
# --------------------------------------------------------------------------

class PortraitAudioDataset:
    """Map-style dataset over clip metadata; ``frame_reader(path, idxs)`` and
    ``audio_feature_reader(path, start_frame)`` are injected so tests can
    fake media IO.

    ``audio_feature_reader`` returns ``(mel, window_offset)``: the log-mel of
    the reference's 30-second raw-audio window containing ``start_frame``
    (``get_audio_file``, reference dataset 632-654 — silence padding happens
    in the SAMPLE domain there, which is why the window selection cannot be
    done on a whole-clip mel) and the frame offset remapped into that
    window. See ``slice_audio_window`` + ``frontend.audio.log_mel_spectrogram``
    for the production implementation (``training/train.py``)."""

    def __init__(
        self,
        clips: List[Dict[str, Any]],
        config: DataConfig,
        frame_reader: Callable[[str, Sequence[int]], np.ndarray],
        audio_feature_reader: Optional[
            Callable[[str, int], Tuple[np.ndarray, int]]] = None,
        rng: Optional[random.Random] = None,
    ):
        self.clips = clips
        self.cfg = config
        self.frame_reader = frame_reader
        self.audio_feature_reader = audio_feature_reader
        self.rng = rng or random.Random(0)
        self.resampled = 0      # draws refused or failed, in this process

    def __len__(self):
        return len(self.clips)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        """Retry-on-exception AND retry-on-gate-trigger both resample a
        random index (reference 776-786, 841-845), bounded here so broken
        metadata cannot loop forever."""
        error = None
        for _ in range(self.cfg.retry):
            try:
                sample = self._load(index)
                if sample is not None:
                    return sample
                error = None
            except Exception as e:    # noqa: BLE001 (the reference resamples)
                error = e
            self.resampled += 1
            index = self.rng.randrange(len(self.clips))
        raise RuntimeError(
            f"dataset retries exhausted ({self.cfg.retry} draws; the last "
            f"{'raised' if error else 'was refused by a gate'})") from error

    def _load(self, index: int) -> Optional[Dict[str, Any]]:
        cfg = self.cfg
        rng = self.rng
        clip = self.clips[index]
        n_frames = int(clip["frames"])
        t = cfg.n_sample_frames
        s, e = clip.get("valid_clip", (0, n_frames))

        drive_idxs, src_idx, step = sample_clip_indices(rng, s, e, t)

        frames = self.frame_reader(clip["video_path"], drive_idxs)
        ref_frame = self.frame_reader(clip["video_path"], [src_idx])[0]
        h, w = ref_frame.shape[:2]

        bboxes = np.asarray(clip["bboxes"], np.float64)
        if len(bboxes) != n_frames:
            bboxes = np.tile(bboxes[:1], (n_frames, 1))
        landmarks = clip.get("landmarks")

        # union masks over the WHOLE valid clip (reference 725-735)
        face_box = union_bbox(bboxes[s:e])
        if landmarks is not None and len(np.asarray(landmarks[s])) >= 68:
            mouth_box = mouth_union_box(
                [np.asarray(landmarks[i]) for i in range(s, e)])
        else:  # box-prior fallback: lower half of the face box
            mouth_box = np.array([face_box[0],
                                  (face_box[1] + face_box[3]) / 2,
                                  face_box[2], face_box[3]])
        face_mask = box_mask(h, w, face_box)
        mouth_mask = box_mask(h, w, mouth_box)
        exp_mask = face_mask - mouth_mask

        # ArcFace head crop of the ref frame at its own frame bbox (458-471)
        bx = [int(v) for v in bboxes[src_idx]]
        head = ref_frame[max(bx[1], 0):max(bx[3], bx[1] + 1),
                         max(bx[0], 0):max(bx[2], bx[0] + 1)]
        head_crop = resize_image(head, (112, 112)).astype(np.float32) \
            / 127.5 - 1.0 if head.size else np.zeros((112, 112, 3), np.float32)

        # crop/scale/aspect/size augmentation (740-760)
        scale = 2 * rng.random()
        bbox_s = process_bbox(list(face_box), scale, h, w)
        if cfg.deterministic_shape:
            aspect = "1:1"
            image_size = float(cfg.image_size)
        else:
            aspect = rng.choice(["1:1", "9:16", "16:9"])
            image_size = 512 + (cfg.image_size - 512) * rng.random()
        bbox_aspect = get_bbox_by_aspect(bbox_s, aspect, w, h)

        side = int(image_size) // 64 * 64

        def cr(img):
            return crop_resize_img(
                img, bbox_aspect, image_size,
                out_hw=(side, side) if cfg.deterministic_shape else None)

        ref_img = cr(ref_frame)
        frames_raw = frames  # keep the decoded drive frames for the VASA crops
        frames = np.stack([cr(f) for f in frames])
        u8 = lambda m: (m * 255).astype(np.uint8)  # noqa: E731
        mask_triplet = {
            "pose": cr(u8(face_mask)).astype(np.float32) / 255.0,
            "mouth": cr(u8(mouth_mask)).astype(np.float32) / 255.0,
            "exp": cr(u8(np.clip(exp_mask, 0, 1))).astype(np.float32) / 255.0,
        }

        # motion buckets + gates (771-786)
        if landmarks is not None and len(np.asarray(landmarks[s])) == 256:
            lmks = [np.asarray(landmarks[i], np.float64) for i in drive_idxs]
            mb_head, mb_exp = get_head_exp_motion_bucketid(
                lmks, cfg.motion_bucket_max)
            if check_lmk(lmks) > cfg.motion_bucket_max:
                return None  # landmark-glitch gate -> resample
        else:
            lm = np.asarray(landmarks, np.float32)[drive_idxs] \
                if landmarks is not None else np.zeros((t, 1, 2), np.float32)
            mb_exp = motion_bucket_from_landmarks(lm, cfg.motion_bucket_max)
            mb_head = mb_exp
        small = np.stack([
            resize_image(f, (f.shape[0] // 4, f.shape[1] // 4))
            for f in frames
        ])
        mb_flow = motion_bucket_from_flow(small, 255)
        if mb_flow > cfg.motion_bucket_max:
            return None  # high-motion gate -> resample (781-786)

        # VASA crops (789-816): per-frame face crop (color-jittered) + pose
        vasa_face, vasa_pose = [], []
        vs = cfg.vasa_image_size
        for i, di in enumerate(drive_idxs):
            fr_full = frames_raw[i]   # already decoded above; no re-read
            img = fr_full
            if cfg.color_jitter:
                img = augmentation_mtn(rng, img)
            if landmarks is not None and len(np.asarray(landmarks[di])) == 256:
                flm = np.asarray(landmarks[di], np.float64)[:174]
                fb = [flm[:, 0].min(), flm[:, 1].min(),
                      flm[:, 0].max(), flm[:, 1].max()]
            else:
                fb = bboxes[di]
            face_c = center_crop(img, fb)
            if face_c.size == 0:
                face_c = img
            vasa_face.append(resize_image(face_c, (vs, vs))
                             .astype(np.float32) / 255.0)
            pose_c = center_crop(fr_full, bboxes[di], scale=1.7)
            if pose_c.size == 0:
                pose_c = fr_full
            vasa_pose.append(resize_image(pose_c, (vs, vs))
                             .astype(np.float32) / 255.0)

        audio, audio_offset = None, drive_idxs[0]
        if self.audio_feature_reader and clip.get("audio_path"):
            audio, audio_offset = self.audio_feature_reader(
                clip["audio_path"], drive_idxs[0])

        return {
            "frames": frames.astype(np.float32) / 127.5 - 1.0,
            "ref_frame": ref_img.astype(np.float32) / 127.5 - 1.0,
            "pose_mask": mask_triplet["pose"],
            "mouth_mask": mask_triplet["mouth"],
            "exp_mask": mask_triplet["exp"],
            "head_crop": head_crop,
            "vasa_face": np.stack(vasa_face),
            "vasa_pose": np.stack(vasa_pose),
            "motion_bucket": mb_head,
            "motion_bucket_exp": mb_exp,
            "motion_bucket_flow": mb_flow,
            "audio_features": audio,
            "audio_offset": audio_offset,
            "audio_step": step,
            "fps": float(clip.get("fps", 25.0)) / step,
            "frame_indices": drive_idxs,
        }


def slice_audio_window(audio_16k: np.ndarray, start_index: int,
                       fps: int = 25, window_s: int = 30
                       ) -> Tuple[np.ndarray, int]:
    """30-second whisper-window selection (``get_audio_file`` 632-654):
    advance whole windows until the clip start falls inside one; if the clip
    tail would cross the window end, back off 4 s. Returns (window samples,
    start index remapped into the window)."""
    sr = 16000
    win = fps * window_s
    while start_index >= win:
        audio_16k = audio_16k[sr * window_s:]
        start_index -= win
    if start_index + 2 * fps >= win:
        start_index -= 4 * fps
        audio_16k = audio_16k[sr * 4:sr * (window_s + 4)]
    else:
        audio_16k = audio_16k[:sr * window_s]
    return audio_16k, start_index


# --------------------------------------------------------------------------
# Media readers (module-level classes: they pickle into worker processes)
# --------------------------------------------------------------------------

class VideoFrameReader:
    """``frame_reader`` over video files: decodes the first ``max(idxs) + 1``
    frames (``frontend.video.read_frames``) and returns (len(idxs), H, W,
    3) uint8 RGB."""

    def __call__(self, path: str, idxs: Sequence[int]) -> np.ndarray:
        from actalker_tpu_torch.frontend import video as V

        return V.read_frames(path, limit=max(idxs) + 1)[list(idxs)]


class NpyFrameReader:
    """``frame_reader`` over ``.npy`` stacks of (T, H, W, 3) uint8 RGB frames
    (a corpus decoded ahead of time, for machines without a video
    decoder); memory-mapped, so only the indexed frames are read."""

    def __call__(self, path: str, idxs: Sequence[int]) -> np.ndarray:
        return np.asarray(np.load(path, mmap_mode="r")[list(idxs)])


class AudioWindowReader:
    """``audio_feature_reader``: the reference's ``get_audio_file`` — the
    30 s raw-audio window containing the clip start (``slice_audio_window``,
    silence padding in the sample domain), then one (80, 3000) log-mel."""

    def __call__(self, path: str, start_frame: int) -> Tuple[np.ndarray, int]:
        from actalker_tpu_torch.frontend import audio as A

        window, offset = slice_audio_window(A.load_audio(path), start_frame)
        return A.log_mel_spectrogram(window)[:, :3000], offset
