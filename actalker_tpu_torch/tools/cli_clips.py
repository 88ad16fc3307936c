"""Whole clips through the inference CLI on the card, timed by stage.

    python -m actalker_tpu_torch.tools.cli_clips --cell C6
    python -m actalker_tpu_torch.tools.cli_clips --cell C5
    python -m actalker_tpu_torch.tools.cli_clips --cell C3 [--norm fused]

C6: 512 px, 14-frame windows, 25 denoise steps, 14 frames (the clip of
``chip_smoke.py`` phase 5 at its full step count; 2 windows a step). C5:
the longform, 125 frames at 512 px, 14-frame windows, 25 steps, decode
chunks of 10 (the operating point of ``tools/run_longform.py``, there in
mode 0 through the JAX CLI; here in mode 2 as the other cells). C3:
``configs/inference.yaml`` as it stands (576 px, 25-frame windows, 25
steps) over 500 frames, the reference's default clip (21 windows a step:
``bench.py``'s derivation of its ~6 min H100 figure). Each runs one window
a UNet call, as the reference's loop does (all 21 of C3's in one batch
would not fit the card). All in mode 2 (no
driving video), seeded weights (``--random-weights``), a seeded 512 / 576
px portrait and tones as speech, written under ``--out`` (git-ignored
``cli_clips_out/`` by default). ``--norm fused`` runs the fused-norm
configuration (K7-LN, K7-GN, K8). C6 runs twice (the second is the
reading); C5 and C3 once, cold, as a user runs them.

Prints the card line, then per run the stage seconds (detect, preprocess, mel,
whisper, tokens, generate_latents, decode, and write where this machine
has a video encoder), the UNet calls and seconds per window-step, the peak
``torch.cuda.max_memory_allocated``, and a JSON line. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import time
import wave

import numpy as np
import torch
from PIL import Image

from actalker_tpu_torch import cli
from actalker_tpu_torch.frontend import video as V
from actalker_tpu_torch.models import common, resnet
from actalker_tpu_torch.pipeline.sampler import make_plan

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# cell -> (config overrides, video frames)
CELLS = {"C6": (dict(image_size=512, n_sample_frames=14, num_inference_steps=25,
                     decode_chunk_size=14, windows_per_call=1), 14),
         "C5": (dict(image_size=512, n_sample_frames=14, num_inference_steps=25,
                     decode_chunk_size=10, windows_per_call=1), 125),
         "C3": (dict(windows_per_call=1), 500)}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0]


def write_inputs(out: str, px: int, frames: int):
    """A seeded portrait (px x px PNG) and speech-band tones long enough for
    ``frames`` video frames (two 640-sample hops each), as a 16 kHz WAV."""
    os.makedirs(out, exist_ok=True)
    rng = np.random.default_rng(0)
    ref = os.path.join(out, f"portrait{px}.png")
    Image.fromarray((rng.random((px, px, 3)) * 255).astype(np.uint8)).save(ref)
    t = np.arange((2 * frames + 1) * 640) / 16000
    tone = sum(a * np.sin(2 * np.pi * f * t) for a, f in ((0.3, 180), (0.2, 720)))
    wav = os.path.join(out, f"speech{frames}.wav")
    with wave.open(wav, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((tone * 32767).astype(np.int16).tobytes())
    return ref, wav


def run_cell(cell: str, out: str, card: str, pipes: dict) -> dict:
    overrides, frames = CELLS[cell]
    cfg = dataclasses.replace(
        cli.load_config(os.path.join(ROOT, "configs", "inference.yaml")),
        seed=0, output_dir=out, exp_name=cell, arcface_checkpoint_path="",
        **overrides)
    ref, wav = write_inputs(out, cfg.image_size, frames)
    args = argparse.Namespace(config="configs/inference.yaml", ref=ref, audio=wav,
                              video=None, mode=2, batch=False, random_weights=True,
                              frame_limit=2 * frames, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = cli.generate_frames(cfg, args, cli.MODE_GATES[2], pipes,
                              detector=lambda im: None)
    if V.have_encoder():
        cli.write_outputs(cfg, args, res)
    wall = time.perf_counter() - t0
    scfg = cfg.sampler_config(cli.MODE_GATES[2])
    plan = make_plan(scfg, res["num_frames"])
    n_win = plan.window_idx.shape[1]
    calls = len(plan.timesteps) * math.ceil(n_win / (scfg.windows_per_call or n_win))
    rec = {"cell": cell, "px": cfg.image_size, "frames": res["num_frames"],
           "window": cfg.n_sample_frames, "steps": len(plan.timesteps),
           "windows_per_step": n_win, "unet_calls": calls,
           "stages_s": res["seconds"], "wall_s": wall,
           "sec_per_window_step": res["seconds"]["generate_latents"]
           / (len(plan.timesteps) * n_win),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "finite": bool(np.isfinite(res["frames01"]).all()),
           "norm": common.norm_impl(), "card": card}
    print(f"[{cell}] {rec['px']} px, {rec['frames']} frames, {rec['window']}-frame "
          f"windows x {n_win} a step, {rec['steps']} steps ({calls} UNet calls): "
          f"stages (s) { {k: round(v, 3) for k, v in res['seconds'].items()} } | "
          f"seconds per window-step {rec['sec_per_window_step']:.4f} | wall "
          f"{wall:.1f} s | peak {rec['peak_gib']:.2f} GiB | finite {rec['finite']} | "
          f"{'written' if V.have_encoder() else 'no video encoder: frames only'} | "
          f"{card}", flush=True)
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cell", choices=sorted(CELLS), action="append")
    parser.add_argument("--norm", choices=("xla", "fused"), default="xla")
    parser.add_argument("--out", default=os.path.join(ROOT, "cli_clips_out"))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("cli_clips measures the card: no CUDA device")
    card = card_line()
    print(card, flush=True)
    common.set_norm_impl(args.norm)
    resnet.set_resconv_impl("pallas" if args.norm == "fused" else "xla")
    pipes: dict = {}
    for cell in args.cell or ["C6", "C3"]:
        for _ in range(2 if cell == "C6" else 1):
            run_cell(cell, args.out, card, pipes)


if __name__ == "__main__":
    main()
