"""Training entry point, twin of ``actalker_tpu/training/train.py``: batches
(``--synthetic N`` generated ones, or ``--metadata`` clips through the
dataset, the worker-process loader and the frozen encoders) -> the
differentiable step over the five trainable artifacts -> AdamW with
clipping and accumulation -> optional commit-gated EMA ->
``checkpoint-<step>`` directories with rotation -> JSONL metrics ->
optional export of the six reference ``.pth`` files.

    python -m actalker_tpu_torch.training.train --config configs/train.yaml \
        (--metadata clips.json ... | --synthetic 8) [--steps 8] \
        [--output train_output] [--micro-model] [--export-reference DIR] \
        [--device cuda|cpu] [--dp N] [--tp M]

    torchrun --nproc_per_node N -m actalker_tpu_torch.training.train ...

It runs on one card (``--device cuda``, the default: bf16 compute, fp32
master parameters and optimizer state) or on the CPU in fp32. Under
torchrun (or any launcher that sets ``RANK`` / ``WORLD_SIZE`` /
``MASTER_ADDR`` / ``MASTER_PORT``) it trains data-parallel with ZeRO-2
(``trainer.ShardedOptimizer``; NCCL, gloo for ``--device cpu``):
``data.train_bs`` is the global batch, each rank loads and steps its own
rows, the logged loss is the global mean, and rank 0 alone writes the
metrics, the checkpoints and the export. ``--tp M`` adds tensor
parallelism (``parallel/tensor.py``): the ranks form a (dp, tp) layout
with tp the fast axis (rank = i_dp * M + i_tp), each tp group holds one
model in slices and takes one dp block of the batch (the same rows, the
same draws), ZeRO-2 runs over each dp group, and the checkpoints and the
export gather the slices, so they are the one-card files; ``dp * tp``
must equal the world size (``--dp`` defaults to world / tp) and tp must
divide every UNet width. With
``--metadata`` the config's ``data.num_workers`` is the number of loader
worker processes (0: synchronous); clips are decoded by
``frontend/video.read_frames`` unless ``main`` is handed another
``frame_reader`` (``training/data.py::NpyFrameReader`` reads ``.npy``
frame stacks on a machine without a video decoder).
"""
from __future__ import annotations

import argparse
import os
import time
from types import SimpleNamespace
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from actalker_tpu_torch.config import read_config
from actalker_tpu_torch.io import checkpoint as ckpt
from actalker_tpu_torch.io import weights as W
from actalker_tpu_torch.io.init import (
    cast_params_bf16_, load_arcface, load_frozen_encoders,
    load_reference_checkpoints, random_init_)
from actalker_tpu_torch.models.pose_guider import PoseGuider
from actalker_tpu_torch.models.projections import (
    AudioProjModel, IDProjModel, VasaProjModel)
from actalker_tpu_torch.models.unet import UNetConfig, UNetSpatioTemporalCondition
from actalker_tpu_torch.models.vae import AutoencoderKLTemporalDecoder, VAEConfig
from actalker_tpu_torch.models.vasa import HeadExpression, HeadPose
from actalker_tpu_torch.models.whisper import WhisperEncoder
from actalker_tpu_torch.parallel import distributed as P
from actalker_tpu_torch.parallel.tensor import TPGroup, shard_modules_, tp_width_error
from actalker_tpu_torch.pipeline.pipeline import ACTalkerPipeline, PipelineModules
from actalker_tpu_torch.training import data as D
from actalker_tpu_torch.training.batch_builder import BatchBuilder
from actalker_tpu_torch.training.ema import ema_init, ema_step
from actalker_tpu_torch.training.loader import prefetch_batches
from actalker_tpu_torch.training.trainer import TrainBatch, TrainConfig, Trainer
from actalker_tpu_torch.utils.observability import MetricsEmitter

# the reference's trainable artifacts (the adapter to_k_ip / to_v_ip rows
# live inside the UNet and export separately)
TRAINABLE = ("unet", "pose_guider", "audio_proj", "id_proj", "vasa_proj")


def synthetic_batches(batch_size: int, frames: int, latent_hw: int,
                      seed: int = 0, device="cpu", raw_heads: bool = True,
                      c0: int = 320) -> Iterator[TrainBatch]:
    """The JAX ``train.py``'s generated batches, drawn from numpy in the same
    order, so one seed gives both packages the same data: raw-head (its
    default) or, with ``raw_heads=False``, pre-encoded tokens (d 1024) and
    pose features of ``c0`` channels."""
    rng = np.random.default_rng(seed)
    hw = latent_hw
    px = hw * 8

    def g(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(device)

    while True:
        if raw_heads:
            fields = dict(audio_feats=g(batch_size, frames, 10, 5, 384),
                          id_embed=g(batch_size, 512),
                          vasa_expr=g(batch_size, frames, 512),
                          vasa_rot=g(batch_size, frames, 3),
                          pose_pixels=g(batch_size, px, px, 3))
        else:
            fields = dict(id_tokens=g(batch_size, 1, 1024),
                          audio_tokens=g(batch_size, frames, 32, 1024),
                          vasa_tokens=g(batch_size, frames, 1, 1024),
                          pose_fea=g(batch_size, frames, hw, hw, c0))
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


# the checkpoint keys of the frozen encoders (``io/init.py::load_frozen_encoders``)
_ENCODER_KEYS = ("pretrained_model_name_or_path", "whisper_model",
                 "vasa_checkpoint_path")


def build_pipeline(mods: Dict[str, torch.nn.Module], ckpt_cfg: Dict,
                   reference_loaded: bool, micro: bool, device, dtype
                   ) -> ACTalkerPipeline:
    """The builder's pipeline: the trainer's own five modules (fp32
    masters, so the batches and the step read the parameters the optimizer
    updates) with the frozen VAE, whisper and VASA towers, seeded as
    ``cli.build_pipeline`` seeds them, then loaded from the files the
    ``checkpoints:`` section names where they exist; cast to bf16 on the
    card. A run started from the reference's files refuses a random VAE or
    whisper, and takes zero expression conditioning without the VASA
    file."""
    vcfg = VAEConfig().tiny() if micro else VAEConfig()
    with torch.device("meta"):
        frozen = {"vae": AutoencoderKLTemporalDecoder(vcfg, dtype=dtype),
                  "whisper": WhisperEncoder(),
                  "vasa_expression": HeadExpression(), "vasa_pose": HeadPose()}
    for seed, m in zip((1, 6, 7, 8), frozen.values()):
        random_init_(m, seed=seed, device=device)
    paths = SimpleNamespace(**{k: (ckpt_cfg or {}).get(k) or "" for k in _ENCODER_KEYS})
    loaded = load_frozen_encoders(paths, frozen)
    if reference_loaded:
        missing = {"vae", "whisper"} - loaded
        if missing:
            raise SystemExit(f"[train] reference checkpoints loaded but the "
                             f"frozen encoders {sorted(missing)} are missing: "
                             "name their files in checkpoints:")
    print(f"[train] frozen encoders: {sorted(loaded) or 'random'}", flush=True)
    for m in frozen.values():
        if dtype == torch.bfloat16:
            cast_params_bf16_(m)
        m.eval()
    towers = "vasa_expression" in loaded or not reference_loaded
    pm = PipelineModules(
        unet=mods["unet"], vae=frozen["vae"], audio_proj=mods["audio_proj"],
        id_proj=mods["id_proj"], vasa_proj=mods["vasa_proj"],
        pose_guider=mods["pose_guider"], whisper=frozen["whisper"],
        vasa_expression=frozen["vasa_expression"] if towers else None,
        vasa_pose=frozen["vasa_pose"] if towers else None)
    return ACTalkerPipeline(pm, dtype=dtype)


def real_batches(builder: BatchBuilder, clips, batch_size: int, frames: int,
                 image_size: int, num_workers: int = 4, start: int = 0,
                 stride: Optional[int] = None, frame_reader=None
                 ) -> Iterator[TrainBatch]:
    """Metadata-driven batches: ``PortraitAudioDataset`` over ``clips`` ->
    ``prefetch_batches`` on ``num_workers`` worker processes -> ``builder``
    on this process (the frozen encoders on the trainer's device).
    ``frame_reader`` defaults to ``data.VideoFrameReader``; audio is the
    30 s window through ``slice_audio_window`` and the log-mel."""
    ds = D.PortraitAudioDataset(
        clips,
        # deterministic shapes whenever samples are stacked across a batch
        # (keyed on stride, the global batch under data parallelism); the
        # reference trains one sample a card with the random-size
        # augmentation, which batch 1 keeps
        D.DataConfig(n_sample_frames=frames, image_size=image_size,
                     deterministic_shape=(stride or batch_size) > 1),
        frame_reader or D.VideoFrameReader(),
        audio_feature_reader=D.AudioWindowReader())
    yield from prefetch_batches(ds, batch_size, builder, num_workers=num_workers,
                                start=start, stride=stride)


def main(argv=None, observe: Optional[Callable] = None,
         frame_reader=None) -> Dict:
    """Run the driver; returns a summary (records per micro-step, final
    step, output directory). ``observe(trainer, record)``, if given, is
    called once before the first micro-step (record None) and after each.
    ``frame_reader`` replaces the video decoder of ``--metadata`` clips."""
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
    parser.add_argument("--dp", type=int, default=None,
                        help="data-parallel ranks (default WORLD_SIZE / tp)")
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel ranks; dp x tp must equal WORLD_SIZE")
    args = parser.parse_args(argv)
    if not (args.synthetic or args.metadata):
        raise SystemExit("provide --metadata clip JSONs (real data) or "
                         "--synthetic N (generated batches)")
    clips = None if args.synthetic else D.load_metadata(args.metadata)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to train on "
                           "the CPU")
    joined = not P.dist.is_initialized()
    sharded = P.init_distributed(device)
    joined = joined and sharded
    try:
        return _run(args, clips, device, sharded, observe, frame_reader)
    finally:
        if joined:
            P.dist.destroy_process_group()


def _run(args, clips, device, sharded, observe, frame_reader) -> Dict:
    world, rank = P.world_size(), P.get_rank()
    cfg = read_config(args.config)
    ucfg = UNetConfig(ablate=tuple(cfg.get("ablate") or ()),
                      gradient_checkpointing=bool(
                          (cfg.get("solver") or {}).get("gradient_checkpointing", False)))
    if args.micro_model:
        ucfg = ucfg.micro()
    tp = args.tp
    if tp < 1:
        raise SystemExit(f"--tp {tp}: at least 1")
    if tp_width_error(ucfg.block_out_channels, tp):
        raise SystemExit(tp_width_error(ucfg.block_out_channels, tp))
    dp = world // tp if args.dp is None else args.dp
    if dp * tp != world:
        raise SystemExit(f"--dp {dp} x --tp {tp} != the {world} ranks launched "
                         "(WORLD_SIZE)")
    dp_group = tp_group = None
    i_dp = rank
    if tp > 1:
        dp_group, tp_group, i_dp, i_tp = P.mesh_groups(dp, tp)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())

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
    # train_bs is the GLOBAL batch (the reference's per-card batch x cards)
    batch_size = int(data_cfg.get("train_bs", 1))
    image_size = int(data_cfg.get("image_size", 512))
    if args.micro_model:
        image_size, frames = 64, min(frames, 2)
        batch_size = max(batch_size, dp)
    if batch_size % dp:
        raise SystemExit(f"train_bs ({batch_size}) must divide evenly over "
                         f"{dp} data-parallel ranks")
    local_bs = batch_size // dp
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    latent_hw = image_size // 8

    mods = build_modules(ucfg, device, dtype)
    loaded = load_reference_checkpoints(mods, cfg.get("checkpoints"))
    if rank == 0:
        print(f"[train] init: {'reference ' + str(loaded) if loaded else 'random'}"
              f" | UNet {sum(p.numel() for p in mods['unet'].parameters())} params"
              f" | {image_size} px x {frames} frames, batch {batch_size}"
              f" over {world} rank(s) (dp {dp} x tp {tp})", flush=True)
    plan = None
    if tp > 1:
        # the micro model's layers all fall below the flagship threshold;
        # it shards them as the JAX package's tests do (min_size 128)
        plan = shard_modules_(mods, TPGroup(tp_group, tp, i_tp),
                              min_size=128 if args.micro_model else 2 ** 14)

    out_dir = args.output
    if rank == 0:
        os.makedirs(out_dir, exist_ok=True)
    use_ema = bool(cfg.get("use_ema", False))
    ema = None
    start_step = 0
    P.barrier()            # rank 0's last checkpoint is whole before any reads
    last = ckpt.latest_checkpoint(out_dir)
    if last is not None:
        state = ckpt.restore_checkpoint(out_dir, last)
        for name, m in mods.items():
            sd = state["params"][name]
            m.load_state_dict(sd if plan is None else plan.cut(name, sd), strict=True)
        if use_ema and "ema" in state:
            ema = {n: {k: v.to(device) for k, v in
                       (sd if plan is None else plan.cut(n, sd)).items()}
                   for n, sd in state["ema"].items()}
        start_step = last
        print(f"[train] resuming from checkpoint-{last}", flush=True)
    if use_ema and ema is None:
        ema = ema_init(mods)

    trainer = Trainer(mods, tcfg, dtype, sharded=sharded, group=dp_group, tp_plan=plan)
    max_steps = args.steps or int(solver.get("max_train_steps", 250000))
    ckpt_every = int(cfg.get("checkpointing_steps", 2000))
    total_limit = int(cfg.get("total_limit", 3))
    builder = None
    if args.synthetic:
        # each dp block its own stream (the JAX trainer seeds with the
        # process); the tp ranks of a block see the same rows
        batches = synthetic_batches(local_bs, frames, latent_hw, seed=i_dp,
                                    device=device)
        n_steps = args.synthetic
    else:
        pipe = build_pipeline(mods, cfg.get("checkpoints"), bool(loaded),
                              args.micro_model, device, dtype)
        arc = cfg.get("arcface_checkpoint_path")
        builder = BatchBuilder(pipe, arcface=load_arcface(
            arc, device) if arc and os.path.exists(arc) else None)
        batches = real_batches(builder, clips, local_bs, frames, image_size,
                               num_workers=int(data_cfg.get("num_workers", 4)),
                               start=i_dp * local_bs, stride=batch_size,
                               frame_reader=frame_reader)
        n_steps = max_steps - start_step
    gen = torch.Generator(device=device).manual_seed(0)

    def whole(name, sd):
        """The one-card dict of a module's (or its EMA's) entries: under
        tensor parallelism a collective every rank takes part in."""
        return sd if plan is None else plan.gather(name, sd)

    def state():
        s = {"params": {n: {k: v.detach().cpu() for k, v in
                            whole(n, m.state_dict()).items()}
                        for n, m in mods.items()}}
        if ema is not None:
            s["ema"] = {n: {k: v.cpu() for k, v in whole(n, sd).items()}
                        for n, sd in ema.items()}
        return s

    records = []
    final_step = start_step
    t_start = time.perf_counter()
    if observe is not None:
        observe(trainer, None)
    emitter = MetricsEmitter(os.path.join(out_dir, "metrics.jsonl")
                             if rank == 0 else os.devnull)

    def save(step):
        P.barrier()        # no rank still reads a checkpoint rotation removes
        s = state() if rank == 0 or plan is not None else None
        if rank == 0:
            ckpt.save_checkpoint(out_dir, step, s, total_limit)
    try:
        for step in range(start_step, min(start_step + n_steps, max_steps)):
            t_batch = time.perf_counter()
            batch = next(batches)
            t0 = time.perf_counter()
            m = trainer.step(batch, generator=gen)
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
                   # blocked on the loader, and in the frozen encoders
                   "load_seconds": t0 - t_batch - (builder.seconds if builder else 0.0),
                   "encode_seconds": builder.seconds if builder else 0.0,
                   "sec_per_step": (time.perf_counter() - t_start)
                   / (step - start_step + 1)}
            records.append(emitter.emit(**rec))
            if observe is not None:
                observe(trainer, rec)
            if ckpt_every and final_step % ckpt_every == 0:
                save(final_step)
    finally:
        batches.close()          # stops the loader's worker processes
        emitter.close()
    save(final_step)
    exported = []
    if args.export_reference:
        sds = None if plan is None else {n: whole(n, m.state_dict())
                                         for n, m in mods.items()}
        if rank == 0:
            exported = W.export_reference_checkpoint(
                mods, args.export_reference, final_step, state_dicts=sds)
    return {"records": records, "final_step": final_step,
            "start_step": start_step, "output": out_dir, "exported": exported,
            "modules": mods, "tp_plan": plan}


if __name__ == "__main__":
    main()
