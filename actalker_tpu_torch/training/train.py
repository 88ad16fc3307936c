"""Training driver, twin of ``actalker_tpu/training/train.py`` on its
``--synthetic`` path: generated batches -> the differentiable step over the
five trainable artifacts -> AdamW with clipping and accumulation ->
optional commit-gated EMA -> ``checkpoint-<step>`` directories with
rotation -> JSONL metrics -> optional export of the six reference ``.pth``
files.

    python -m actalker_tpu_torch.training.train --config configs/train.yaml \
        --synthetic 8 --steps 8 --output train_output [--micro-model] \
        [--export-reference DIR] [--device cuda|cpu]

It runs on one card (``--device cuda``, the default: bf16 compute, fp32
master parameters and optimizer state) or on the CPU in fp32. Real data
(``--metadata``) needs the frozen encoders' port and is refused.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from actalker_tpu_torch.config import read_config
from actalker_tpu_torch.io import checkpoint as ckpt
from actalker_tpu_torch.io import weights as W
from actalker_tpu_torch.io.init import load_reference_checkpoints, random_init_
from actalker_tpu_torch.models.pose_guider import PoseGuider
from actalker_tpu_torch.models.projections import (
    AudioProjModel, IDProjModel, VasaProjModel)
from actalker_tpu_torch.models.unet import UNetConfig, UNetSpatioTemporalCondition
from actalker_tpu_torch.training.ema import ema_init, ema_step
from actalker_tpu_torch.training.trainer import TrainBatch, TrainConfig, Trainer

# the reference's trainable artifacts (the adapter to_k_ip / to_v_ip rows
# live inside the UNet and export separately)
TRAINABLE = ("unet", "pose_guider", "audio_proj", "id_proj", "vasa_proj")


def synthetic_batches(batch_size: int, frames: int, latent_hw: int,
                      seed: int = 0, device="cpu") -> Iterator[TrainBatch]:
    """The JAX driver's generated raw-head batches (its default), drawn from
    numpy in the same order, so one seed gives both packages the same
    data."""
    rng = np.random.default_rng(seed)
    hw = latent_hw
    px = hw * 8

    def g(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(device)

    while True:
        fields = dict(audio_feats=g(batch_size, frames, 10, 5, 384),
                      id_embed=g(batch_size, 512),
                      vasa_expr=g(batch_size, frames, 512),
                      vasa_rot=g(batch_size, frames, 3),
                      pose_pixels=g(batch_size, px, px, 3))
        ones = torch.ones((batch_size, 1, px, px), device=device)
        yield TrainBatch(
            latents=g(batch_size, frames, hw, hw, 4),
            ref_latents=g(batch_size, hw, hw, 4),
            audio_mask=ones, exp_mask=ones,
            motion_buckets=torch.full((batch_size, 2), 12.0, device=device),
            fps=torch.full((batch_size,), 12.5, device=device), **fields)


def build_modules(ucfg: UNetConfig, device, dtype, seed: int = 0
                  ) -> Dict[str, torch.nn.Module]:
    """The five trainable modules, seeded (``random_init_``) on ``device``
    with fp32 parameters; the UNet computes in ``dtype``."""
    with torch.device("meta"):
        mods = {"unet": UNetSpatioTemporalCondition(ucfg, dtype=dtype),
                "pose_guider": PoseGuider(
                    embedding_channels=ucfg.block_out_channels[0]),
                "audio_proj": AudioProjModel(), "id_proj": IDProjModel(),
                "vasa_proj": VasaProjModel()}
    for i, m in enumerate(mods.values()):
        random_init_(m, seed=seed + i, device=device).train()
    return mods


def main(argv=None, observe: Optional[Callable] = None) -> Dict:
    """Run the driver; returns a summary (records per micro-step, final
    step, output directory). ``observe(trainer, record)``, if given, is
    called once before the first micro-step (record None) and after each."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default="configs/train.yaml")
    parser.add_argument("--metadata", type=str, nargs="*", default=[])
    parser.add_argument("--synthetic", type=int, default=0,
                        help="train on N synthetic batches")
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument("--output", type=str, default="train_output")
    parser.add_argument("--micro-model", action="store_true",
                        help="the micro UNet (tests / smoke runs)")
    parser.add_argument("--export-reference", type=str, default=None,
                        help="after training, export the six reference-"
                             "contract .pth artifacts to this directory")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    if args.metadata:
        raise NotImplementedError(
            "--metadata needs the encoders' port (ROADMAP item 9); use "
            "--synthetic N")
    if not args.synthetic:
        raise SystemExit("provide --synthetic N (generated batches)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to train on "
                           "the CPU")

    cfg = read_config(args.config)
    solver = cfg.get("solver") or {}
    data_cfg = cfg.get("data") or {}
    tcfg = TrainConfig(
        learning_rate=float(solver.get("learning_rate", 1e-5)),
        weight_decay=float(solver.get("adam_weight_decay", 1e-2)),
        adam_b1=float(solver.get("adam_beta1", 0.9)),
        adam_b2=float(solver.get("adam_beta2", 0.999)),
        adam_eps=float(solver.get("adam_epsilon", 1e-8)),
        max_grad_norm=float(solver.get("max_grad_norm", 1.0)),
        grad_accum_steps=int(solver.get("gradient_accumulation_steps", 1)),
        cond_dropout_prob=float(cfg.get("conditioning_dropout_prob", 0.1)),
        noise_offset=float(cfg.get("noise_offset", 0.05)))
    frames = int(data_cfg.get("n_sample_frames", 25))
    batch_size = int(data_cfg.get("train_bs", 1))
    image_size = int(data_cfg.get("image_size", 512))
    ucfg = UNetConfig(ablate=tuple(cfg.get("ablate") or ()),
                      gradient_checkpointing=bool(
                          solver.get("gradient_checkpointing", False)))
    if args.micro_model:
        ucfg = ucfg.micro()
        image_size, frames = 64, min(frames, 2)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    latent_hw = image_size // 8

    mods = build_modules(ucfg, device, dtype)
    loaded = load_reference_checkpoints(mods, cfg.get("checkpoints"))
    print(f"[train] init: {'reference ' + str(loaded) if loaded else 'random'}"
          f" | UNet {sum(p.numel() for p in mods['unet'].parameters())} params"
          f" | {image_size} px x {frames} frames, batch {batch_size}", flush=True)

    out_dir = args.output
    os.makedirs(out_dir, exist_ok=True)
    use_ema = bool(cfg.get("use_ema", False))
    ema = None
    start_step = 0
    last = ckpt.latest_checkpoint(out_dir)
    if last is not None:
        state = ckpt.restore_checkpoint(out_dir, last)
        for name, m in mods.items():
            m.load_state_dict(state["params"][name], strict=True)
        if use_ema and "ema" in state:
            ema = {n: {k: v.to(device) for k, v in sd.items()}
                   for n, sd in state["ema"].items()}
        start_step = last
        print(f"[train] resuming from checkpoint-{last}", flush=True)
    if use_ema and ema is None:
        ema = ema_init(mods)

    trainer = Trainer(mods, tcfg, dtype)
    max_steps = args.steps or int(solver.get("max_train_steps", 250000))
    ckpt_every = int(cfg.get("checkpointing_steps", 2000))
    total_limit = int(cfg.get("total_limit", 3))
    batches = synthetic_batches(batch_size, frames, latent_hw, seed=0,
                                device=device)
    gen = torch.Generator(device=device).manual_seed(0)

    def state():
        s = {"params": {n: {k: v.detach().cpu() for k, v in m.state_dict().items()}
                        for n, m in mods.items()}}
        if ema is not None:
            s["ema"] = {n: {k: v.cpu() for k, v in sd.items()}
                        for n, sd in ema.items()}
        return s

    records = []
    final_step = start_step
    t_start = time.perf_counter()
    if observe is not None:
        observe(trainer, None)
    with open(os.path.join(out_dir, "metrics.jsonl"), "a") as mf:
        for step in range(start_step, min(start_step + args.synthetic,
                                          max_steps)):
            t0 = time.perf_counter()
            m = trainer.step(next(batches), generator=gen)
            if ema is not None:
                ema_step(ema, mods, m["commit"])
            loss = float(m["loss"])          # waits for the step's kernels
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            final_step = step + 1
            rec = {"step": step, "loss": loss, "commit": m["commit"],
                   "grad_norm": (None if m["grad_norm"] is None
                                 else float(m["grad_norm"])),
                   "seconds": time.perf_counter() - t0,
                   "sec_per_step": (time.perf_counter() - t_start)
                   / (step - start_step + 1)}
            records.append(rec)
            mf.write(json.dumps(rec) + "\n")
            mf.flush()
            if observe is not None:
                observe(trainer, rec)
            if ckpt_every and final_step % ckpt_every == 0:
                ckpt.save_checkpoint(out_dir, final_step, state(), total_limit)
    ckpt.save_checkpoint(out_dir, final_step, state(), total_limit)
    exported = []
    if args.export_reference:
        exported = W.export_reference_checkpoint(mods, args.export_reference,
                                                 final_step)
    return {"records": records, "final_step": final_step,
            "start_step": start_step, "output": out_dir, "exported": exported,
            "modules": mods}


if __name__ == "__main__":
    main()
