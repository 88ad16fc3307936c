"""Samples per second of the real training input path: the port's copy of
``tools/loader_throughput.py``.

    python -m actalker_tpu_torch.tools.loader_throughput [--frames 8]
        [--workers 4] [--batch 8] [--size 512] [--batches 10]
        [--device cuda|cpu] [--micro-model]

A seeded corpus (``write_corpus``: the JAX tool's toy faces, 6 clips of 40
frames at ``--size`` px with grain, as ``.npy`` frame stacks with a 16 kHz
WAV each) goes through ``training.train.real_batches``:
``PortraitAudioDataset`` (crop, resize, masks, colour augmentation) on
``--workers`` worker processes, then the batch builder with the frozen
encoders (VAE, whisper, VASA towers; bf16 on the card) on ``--device``. A batch is one global batch of ``--batch``
samples (the reference: one sample a card over 8 cards). The first batch
is timed alone; then ``--batches`` more. Prints one JSON line: samples/s,
seconds a batch, the first batch's seconds, and the card's name and power
limit where there is one. A data-parallel run starves unless this rate
reaches ``batch / seconds per step``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time
import wave

import numpy as np
import torch


def write_corpus(root: str, n_clips: int = 6, n: int = 40, hw: int = 512) -> str:
    """The toy-face corpus under ``root`` (``clip{c}.npy`` / ``clip{c}.wav``
    and ``meta.json`` with one still box and five landmarks a clip, 8 fps);
    returns the metadata path."""
    rng = np.random.default_rng(0)
    clips = []
    s = hw // 64                       # the scale of the 64 px face layout
    for c in range(n_clips):
        frames = np.full((n, hw, hw, 3), 30 + 10 * c, np.uint8)
        for i in range(n):
            x = (14 + (i + c) % 4) * s
            frames[i, 10 * s:54 * s, x:x + 36 * s] = 170 + c * 10
            frames[i, 20 * s:28 * s, x + 6 * s:x + 14 * s] = 60
            frames[i, 20 * s:28 * s, x + 22 * s:x + 30 * s] = 60
            frames[i, 38 * s:46 * s, x + 10 * s:x + 26 * s] = 90
        frames = np.clip(frames.astype(np.int16) + rng.integers(
            -12, 12, frames.shape, np.int16), 0, 255).astype(np.uint8)
        video = os.path.join(root, f"clip{c}.npy")
        np.save(video, frames)
        audio = os.path.join(root, f"clip{c}.wav")
        t = np.arange(16000 * (n // 8 + 1)) / 16000.0
        pcm = (0.1 * np.sin(2 * np.pi * (200 + 50 * c) * t)
               + 0.01 * rng.standard_normal(t.shape))
        with wave.open(audio, "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(16000)
            f.writeframes((pcm * 32767).astype(np.int16).tobytes())
        box = [14.0 * s, 10.0 * s, 50.0 * s, 54.0 * s]
        lm5 = [[24.0 * s, 24.0 * s], [40.0 * s, 24.0 * s], [32.0 * s, 34.0 * s],
               [26.0 * s, 42.0 * s], [38.0 * s, 42.0 * s]]
        clips.append({"video_path": video, "audio_path": audio, "frames": n,
                      "fps": 8.0, "bboxes": [box] * n, "landmarks": [lm5] * n})
    meta = os.path.join(root, "meta.json")
    with open(meta, "w") as f:
        json.dump(clips, f)
    return meta


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip() or "no card"
    except (OSError, subprocess.SubprocessError):
        return "no card"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--batches", type=int, default=10)
    ap.add_argument("--clips", type=int, default=6)
    ap.add_argument("--clip-frames", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--micro-model", action="store_true",
                    help="the tiny VAE and micro UNet (tests)")
    args = ap.parse_args(argv)

    from actalker_tpu_torch.models.unet import UNetConfig
    from actalker_tpu_torch.training import data as D
    from actalker_tpu_torch.training import train as T
    from actalker_tpu_torch.training.batch_builder import BatchBuilder

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on the CPU")
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    ucfg = UNetConfig().micro() if args.micro_model else UNetConfig()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with tempfile.TemporaryDirectory() as root:
        meta = write_corpus(root, args.clips, args.clip_frames, args.size)
        mods = T.build_modules(ucfg, device, dtype)
        pipe = T.build_pipeline(mods, {}, False, args.micro_model, device, dtype)
        it = T.real_batches(BatchBuilder(pipe), D.load_metadata([meta]), args.batch,
                            args.frames, args.size, num_workers=args.workers,
                            frame_reader=D.NpyFrameReader())
        try:
            t0 = time.perf_counter()
            next(it)
            sync()
            first_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            for _ in range(args.batches):
                next(it)
            sync()
            dt = (time.perf_counter() - t0) / args.batches
        finally:
            it.close()
    out = {"metric": f"loader_samples_per_s_{args.size}px_{args.frames}f_"
                     f"bs{args.batch}_w{args.workers}",
           "value": args.batch / dt, "unit": "samples/s",
           "sec_per_global_batch": dt, "first_batch_s": first_s,
           "device": str(device), "card": card_line() if device.type == "cuda" else None}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
