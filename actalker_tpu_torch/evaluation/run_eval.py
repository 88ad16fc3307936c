"""Directory-level evaluation, twin of ``actalker_tpu/evaluation/run_eval.py``:
the reference's ``eval/run_eval.sh`` / ``run_faceid.sh`` / ``sync.sh`` and
the metric scripts they chain (``eval/evaluation.py:286-333`` Sync-C / D,
``eval/eval_fid.py:109-145`` FID, ``eval/evaluation_faceid.py:187-266``
face-ID cosine, ``utils/video_level_evaluation.py:104-133`` FVD,
``utils/image_level_evaluation.py:12-50`` LPIPS / PSNR / L1) as one command
that writes JSONL:

    python -m actalker_tpu_torch.evaluation.run_eval \\
        --video_dir out/visuals [--ref_video_dir data/gt] \\
        [--image_dir data/refs] [--weights_dir pretrained_models/eval] \\
        [--out results.jsonl] [--device cuda|cpu] [--npy]

The networks run in fp32 on ``--device`` (the card by default). Each is
loaded from its file under ``--weights_dir`` by ``io/init.py::load_*`` with
``strict=True``; a metric is skipped (``null``, said on stderr) only when
its file is missing, and a file that does not load raises. ``--npy`` reads
``.npy`` stacks of (T, H, W, 3) uint8 frames at 25 fps with the audio in a
WAV of the same stem beside each (a machine without a video decoder);
``run`` takes any frame reader and audio reader. A final ``summary``
record holds the means and the corpus-level FID / FVD.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm")
IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp")


class VideoClipReader:
    """Frames and frame rate of video files (``frontend/video.py``)."""

    exts = VIDEO_EXTS

    def frames(self, path: str, limit: Optional[int] = None) -> np.ndarray:
        from actalker_tpu_torch.frontend.video import read_frames

        return read_frames(path, limit=limit)

    def fps(self, path: str) -> float:
        from actalker_tpu_torch.frontend.video import get_fps

        return get_fps(path)


class NpyClipReader:
    """``.npy`` stacks of (T, H, W, 3) uint8 RGB frames at ``fps``."""

    exts = (".npy",)

    def __init__(self, fps: float = 25.0):
        self._fps = fps

    def frames(self, path: str, limit: Optional[int] = None) -> np.ndarray:
        return np.asarray(np.load(path, mmap_mode="r")[:limit])

    def fps(self, path: str) -> float:
        return self._fps


def clip_audio(path: str) -> np.ndarray:
    """The clip's own audio track at 16 kHz."""
    from actalker_tpu_torch.frontend.audio import load_audio

    return load_audio(path, sr=16000)


def wav_beside(path: str) -> np.ndarray:
    """The 16 kHz audio of the WAV with the clip's stem, beside it."""
    from actalker_tpu_torch.frontend.audio import load_audio

    return load_audio(os.path.splitext(path)[0] + ".wav", sr=16000)


def _find_clips(d: str, exts) -> List[str]:
    return sorted(os.path.join(d, f) for f in os.listdir(d)
                  if f.lower().endswith(exts))


def _match_by_stem(path: str, directory: Optional[str], exts) -> Optional[str]:
    if not directory:
        return None
    stem = os.path.splitext(os.path.basename(path))[0]
    for ext in exts:
        cand = os.path.join(directory, stem + ext)
        if os.path.exists(cand):
            return cand
    return None


def _to_nchw(frames: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(frames, np.float32)).to(device).permute(0, 3, 1, 2)


@dataclasses.dataclass
class EvalModels:
    """The metric networks, built on first use on ``device``; each is None
    when its file is missing."""

    weights_dir: str
    device: torch.device = torch.device("cuda")
    _cache: Dict[str, object] = dataclasses.field(default_factory=dict)

    def _load(self, key: str, filenames, build: Callable):
        if key not in self._cache:
            paths = [os.path.join(self.weights_dir, f) for f in filenames]
            missing = [p for p in paths if not os.path.exists(p)]
            if missing:
                print(f"[run_eval] {key}: no weights at {', '.join(missing)}; "
                      "metric skipped", file=sys.stderr)
                self._cache[key] = None
            else:
                self._cache[key] = build(*paths)
        return self._cache[key]

    def sync(self):
        """(SyncNet, S3FD) or None."""
        from actalker_tpu_torch.evaluation.s3fd import S3FD
        from actalker_tpu_torch.io.init import load_s3fd, load_syncnet

        return self._load("syncnet", ("syncnet_v2.model", "sfd_face.pth"),
                          lambda sp, dp: (load_syncnet(sp, self.device),
                                          S3FD(load_s3fd(dp, self.device))))

    def inception(self):
        """(B, H, W, 3) [0, 1] -> (B, 2048), or None."""
        from actalker_tpu_torch.evaluation.inception import inception_feature_fn
        from actalker_tpu_torch.io.init import load_fid_inception

        return self._load("fid_inception", ("pt_inception-2015-12-05.pth",),
                          lambda p: inception_feature_fn(load_fid_inception(p, self.device)))

    def i3d(self):
        """(B, T, 224, 224, 3) [0, 1] -> (B, 1024), or None."""
        from actalker_tpu_torch.evaluation.i3d import i3d_feature_fn
        from actalker_tpu_torch.io.init import load_i3d

        return self._load("i3d", ("i3d_rgb_charades.pt",),
                          lambda p: i3d_feature_fn(load_i3d(p, self.device)))

    def face_embed(self):
        """(N, H, W, 3) uint8 RGB -> (N, 2048) SENet-50 features of the
        224 x 224 bicubic resize, mean-subtracted; or None."""
        from actalker_tpu_torch.io.init import load_senet50
        from actalker_tpu_torch.models.senet import VGGFACE2_MEAN_RGB
        from actalker_tpu_torch.ops.resize import torch_bicubic_resize

        def build(path):
            net = load_senet50(path, self.device)
            mean = torch.tensor(VGGFACE2_MEAN_RGB, device=self.device)[None, :, None, None]

            @torch.no_grad()
            def embed(frames_uint8):
                x = torch_bicubic_resize(_to_nchw(frames_uint8, self.device), 224, 224)
                return net(x - mean).cpu().numpy()

            return embed

        return self._load("senet50", ("senet50_ft_weight.pth",), build)

    def lpips(self):
        """LPIPSAlex, or None."""
        from actalker_tpu_torch.io.init import load_lpips

        return self._load("lpips", ("lpips_alex.pth",),
                          lambda p: load_lpips(p, self.device))


def resize_frames01(frames01: np.ndarray, size: int, device="cpu") -> np.ndarray:
    """(T, H, W, 3) float [0, 1] -> (T, size, size, 3), bicubic, clipped
    to [0, 1] (the FID / I3D input contract)."""
    from actalker_tpu_torch.ops.resize import torch_bicubic_resize

    x = torch_bicubic_resize(_to_nchw(frames01, device), size, size)
    return x.clamp(0.0, 1.0).permute(0, 2, 3, 1).cpu().numpy()


def evaluate_clip(path: str, models: EvalModels, ref_video: Optional[str],
                  ref_image: Optional[str], max_frames: int = 500, frames=None,
                  ref_frames=None, reader=None, audio_reader=None) -> dict:
    """Score one clip. ``frames`` / ``ref_frames`` take already-read uint8
    arrays so a directory run reads each clip once. The sync metric's own
    ``ValueError`` (a tube shorter than one window) becomes its note;
    anything else raises."""
    reader = reader or VideoClipReader()
    audio_reader = audio_reader or clip_audio
    rec: dict = {"clip": os.path.basename(path)}

    sync = models.sync()
    if sync is not None:
        from actalker_tpu_torch.evaluation.sync_eval import evaluate_sync

        try:
            tracks = evaluate_sync(path, sync[0], sync[1], reader, audio_reader,
                                   max_frames=max_frames)
        except ValueError as exc:
            rec.update(sync_c=None, sync_d=None, sync_note=str(exc))
        else:
            if tracks:
                # the reference reports the most confident track
                off, conf, dist = max(tracks, key=lambda t: t[1])
                rec.update(sync_offset=int(off), sync_c=round(float(conf), 4),
                           sync_d=round(float(dist), 4))
            else:
                rec.update(sync_offset=None, sync_c=None, sync_d=None,
                           sync_note="no face track")
    else:
        rec.update(sync_c=None, sync_d=None)

    if frames is None:
        frames = reader.frames(path, max_frames)
    rec["frames"] = int(len(frames))

    embed = models.face_embed()
    if embed is not None and ref_image is not None:
        from PIL import Image

        from actalker_tpu_torch.evaluation.metrics import identity_cosine

        ref = np.asarray(Image.open(ref_image).convert("RGB"))
        step = max(1, len(frames) // 32)
        rec["id_cosine"] = round(identity_cosine(ref, frames[::step], embed), 4)
    else:
        rec["id_cosine"] = None

    if ref_video is not None:
        from actalker_tpu_torch.evaluation.metrics import l1 as l1_m
        from actalker_tpu_torch.evaluation.metrics import lpips as lpips_m
        from actalker_tpu_torch.evaluation.metrics import psnr as psnr_m

        if ref_frames is None:
            ref_frames = reader.frames(ref_video, max_frames)
        n = min(len(frames), len(ref_frames))
        if n and frames.shape[1:] == ref_frames.shape[1:]:
            a = frames[:n].astype(np.float32) / 255.0
            b = ref_frames[:n].astype(np.float32) / 255.0
            rec["psnr"] = round(psnr_m(a, b), 4)
            rec["l1"] = round(l1_m(a, b), 6)
            net = models.lpips()
            if net is not None:
                step = max(1, n // 16)
                rec["lpips"] = round(lpips_m(a[::step], b[::step], net), 4)
    return rec


def run(video_dir: str, ref_video_dir: Optional[str], image_dir: Optional[str],
        weights_dir: str, out_path: str, max_frames: int = 500,
        fid_frames_per_clip: int = 16, device="cuda", reader=None,
        audio_reader=None) -> List[dict]:
    """Score every clip of ``video_dir`` (a clip's reference video and image
    share its stem); print and write the records. ``reader``: frames and fps
    (``VideoClipReader`` by default, ``NpyClipReader``), ``audio_reader``:
    a clip's 16 kHz audio (``clip_audio``, ``wav_beside``)."""
    reader = reader or VideoClipReader()
    clips = _find_clips(video_dir, reader.exts)
    if not clips:
        raise SystemExit(f"no clips ({', '.join(reader.exts)}) in {video_dir}")
    models = EvalModels(weights_dir, torch.device(device))
    records = []
    fake_frames, real_frames, fake_clips, real_clips = [], [], [], []

    for path in clips:
        ref_video = _match_by_stem(path, ref_video_dir, reader.exts)
        ref_image = _match_by_stem(path, image_dir, IMAGE_EXTS)
        f = reader.frames(path, max_frames)
        r = reader.frames(ref_video, max_frames) if ref_video is not None else None
        rec = evaluate_clip(path, models, ref_video, ref_image, max_frames,
                            frames=f, ref_frames=r, reader=reader,
                            audio_reader=audio_reader)
        records.append(rec)
        print(json.dumps(rec))

        if ref_video is not None and (models.inception() is not None
                                      or models.i3d() is not None):
            step = max(1, len(f) // fid_frames_per_clip)
            # a common size lets metrics.fid stack frames across clips
            f01, r01 = (v.astype(np.float32) / 255.0 for v in (f, r))
            fake_frames.extend(resize_frames01(f01[::step], 299, device))
            real_frames.extend(resize_frames01(r01[::step], 299, device))
            if len(f) >= 16 and len(r) >= 16:
                fake_clips.append(resize_frames01(f01[:16], 224, device))
                real_clips.append(resize_frames01(r01[:16], 224, device))

    summary: dict = {"summary": True, "clips": len(records)}
    for key in ("sync_c", "sync_d", "id_cosine", "psnr", "l1", "lpips"):
        vals = [r[key] for r in records if r.get(key) is not None]
        summary[key] = round(float(np.mean(vals)), 4) if vals else None

    inc = models.inception()
    if inc is not None and fake_frames:
        from actalker_tpu_torch.evaluation.metrics import fid as fid_m

        summary["fid"] = round(fid_m(real_frames, fake_frames, inc), 4)
    i3d = models.i3d()
    if i3d is not None and fake_clips:
        from actalker_tpu_torch.evaluation.metrics import fvd as fvd_m

        summary["fvd"] = round(fvd_m(np.stack(real_clips), np.stack(fake_clips), i3d), 4)
    records.append(summary)
    print(json.dumps(summary))

    with open(out_path, "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Score a directory of generated clips (the reference's "
                    "eval/run_eval.sh)")
    ap.add_argument("--video_dir", required=True, help="generated clips to score")
    ap.add_argument("--ref_video_dir", default=None,
                    help="ground-truth clips (same stems) for FID / FVD / PSNR / "
                         "L1 / LPIPS")
    ap.add_argument("--image_dir", default=None,
                    help="source reference images (same stems) for face-ID")
    ap.add_argument("--weights_dir", default="pretrained_models/eval",
                    help="directory holding syncnet_v2.model, sfd_face.pth, "
                         "pt_inception-2015-12-05.pth, i3d_rgb_charades.pt, "
                         "senet50_ft_weight.pth, lpips_alex.pth")
    ap.add_argument("--out", default="eval_results.jsonl")
    ap.add_argument("--max_frames", type=int, default=500)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--npy", action="store_true",
                    help="clips are .npy frame stacks at 25 fps with a WAV of "
                         "the same stem beside each")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to evaluate on the CPU")
    reader, audio = (NpyClipReader(), wav_beside) if args.npy else (None, None)
    return run(args.video_dir, args.ref_video_dir, args.image_dir, args.weights_dir,
               args.out, args.max_frames, device=args.device, reader=reader,
               audio_reader=audio)


if __name__ == "__main__":
    main()
